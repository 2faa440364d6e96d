"""The port's configs (``repro_torch.configs``) against the JAX reference's:
every architecture, its smoke config, its parameter counts, the shape
cells and the paper campaign must be equal field by field.
"""

import dataclasses

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

import repro.configs as ref
import repro_torch.configs as port

ARCH_NAMES = sorted(ref.ARCHS)
DERIVED = ("padded_vocab", "resolved_head_dim", "q_dim", "kv_dim",
           "pattern_layers", "supports_long_context")


def test_same_architectures():
    assert sorted(port.ARCHS) == ARCH_NAMES


@pytest.mark.parametrize("smoke", (False, True), ids=("full", "smoke"))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_config_matches(name, smoke):
    want, got = ref.get_arch(name), port.get_arch(name)
    if smoke:
        want, got = ref.smoke_config(want), port.smoke_config(got)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for attr in DERIVED:
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_shapes_and_input_specs_match(name):
    assert {k: dataclasses.asdict(v) for k, v in port.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()}
    for shape_name in ref.SHAPES:
        want_cfg, got_cfg = ref.get_arch(name), port.get_arch(name)
        want_shape, got_shape = ref.SHAPES[shape_name], port.SHAPES[shape_name]
        assert port.shape_applicable(got_cfg, got_shape) == \
            ref.shape_applicable(want_cfg, want_shape)
        want = ref.input_specs(want_cfg, want_shape)
        got = port.input_specs(got_cfg, got_shape)
        assert sorted(got) == sorted(want)
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(spec.shape)
            assert str(got[key].dtype).removeprefix("torch.") == \
                np.dtype(spec.dtype).name


def test_campaign_matches():
    assert dataclasses.asdict(port.CAMPAIGN) == dataclasses.asdict(ref.CAMPAIGN)
    for n, p in ((44_794, 20), (1_000, 64), (80_000_000, 12)):
        assert port.CAMPAIGN.chunk_params(n, p) == ref.CAMPAIGN.chunk_params(n, p)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        port.get_arch("no-such-model")


def test_configs_import_no_jax():
    import repro_torch.configs.base as base
    assert "jax" not in base.__dict__
    assert isinstance(port.input_specs(port.get_arch("qwen3-4b"),
                                       port.SHAPES["decode_32k"])["tokens"],
                      torch.Tensor)
