"""The port's sharding layer against the reference's on the CPU: for every
arch with its ``sharding_overrides``, on the single-pod (16 x 16) and
two-pod (2 x 16 x 16) production meshes, ``param_shardings`` of the
decoder's parameters and of its decode state, leaf for leaf: the spec,
the shard shape of each device, the axes trees and the meta-tensor specs
(shape and dtype) they are computed from.  Everything compared is exact.

The reference's meshes are ``jax.sharding.AbstractMesh``es (no devices:
this process keeps one CPU device, and no ``XLA_FLAGS``); the port's are
``DeviceMesh``es on the ``fake`` process-group backend, 256 and 512 ranks
that move no data (``repro_torch.launch.mesh.fake_world``).
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
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import mesh as rmesh
from repro.models import attention as rattn
from repro.models import decoder as rdec
from repro.models import recurrent as rrec
from repro.sharding import logical_to_spec as ref_logical_to_spec
from repro.sharding import param_shardings as ref_param_shardings
from repro_torch.configs import ARCHS
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention as tattn
from repro_torch.models import decoder as tdec
from repro_torch.models import recurrent as trec
from repro_torch.sharding import (DEFAULT_RULES, NamedSharding,
                                  logical_to_spec, param_shardings)

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
# decode state: a serving batch that every (pod x data) split divides
STATE_BATCH, STATE_MAX_LEN = 64, 4096


def _leaves(tree, path=""):
    """{path: leaf} of nested dicts / tuples / NamedTuples, any leaf."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, x in enumerate(tree):
            out.update(_leaves(x, f"{path}/{i}"))
        return out
    return {path: tree}


def _same_specs(ref_specs, port_specs, what):
    """The reference's ShapeDtypeStructs against the port's meta tensors."""
    ref, port = _leaves(ref_specs), _leaves(port_specs)
    assert ref.keys() == port.keys(), what
    for k, r in ref.items():
        p = port[k]
        assert p.device.type == "meta", (what, k)
        assert tuple(p.shape) == tuple(r.shape), (what, k)
        assert str(p.dtype).removeprefix("torch.") == str(r.dtype), (what, k)


def _same_axes(ref_axes, port_axes, what):
    ref, port = _leaves(ref_axes), _leaves(port_axes)
    assert ref.keys() == port.keys(), what
    assert {k: a.names for k, a in ref.items()} == {
        k: a.names for k, a in port.items()}, what


def _same_shardings(ref_sh, port_sh, specs, what):
    """Spec and shard shape equal leaf for leaf; returns the leaf count."""
    ref, port, shapes = _leaves(ref_sh), _leaves(port_sh), _leaves(specs)
    assert ref.keys() == port.keys() == shapes.keys(), what
    for k, r in ref.items():
        p = port[k]
        assert isinstance(p, NamedSharding)
        assert p.spec == tuple(r.spec), (what, k, p.spec, r.spec)
        shape = tuple(shapes[k].shape)
        assert p.shard_shape(shape) == tuple(r.shard_shape(shape)), (what, k)
        assert len(p.placements) == len(p.mesh.mesh_dim_names)
    return len(ref)


@pytest.fixture(scope="module")
def ref_specs():
    """The reference's (param specs, axes) and decode-state (specs, axes)
    of every arch, computed once."""
    out = {}
    for name, cfg in REF_ARCHS.items():
        params, axes = rdec.decoder_param_specs(cfg)
        state = rdec.init_decode_state(cfg, STATE_BATCH, STATE_MAX_LEN,
                                       spec=True)
        out[name] = (params, axes, state, rdec.decode_state_axes(cfg))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_and_state_shardings_match_reference(mesh_name, ref_specs):
    shape, names = MESHES[mesh_name]
    ref_mesh = AbstractMesh(shape, names)
    compared = 0
    with tmesh.fake_world(int(np.prod(shape))):
        mesh = tmesh.make_production_mesh(multi_pod=len(shape) == 3,
                                          device_type="cpu")
        assert mesh.mesh_dim_names == names and mesh.shape == shape
        for name, cfg in ARCHS.items():
            overrides = dict(cfg.sharding_overrides) or None
            rrules = rmesh.production_rules(ref_mesh, overrides)
            rules = tmesh.production_rules(mesh, overrides)
            assert rules.rules == rrules.rules, name
            rparams, raxes, rstate, rsaxes = ref_specs[name]
            params, axes = tdec.decoder_param_specs(cfg)
            state = tdec.init_decode_state(cfg, STATE_BATCH, STATE_MAX_LEN,
                                           spec=True)
            saxes = tdec.decode_state_axes(cfg)
            _same_specs(rparams, params, name)
            _same_axes(raxes, axes, name)
            _same_specs(rstate, state, name)
            _same_axes(rsaxes, saxes, name)
            compared += _same_shardings(
                ref_param_shardings(rrules, rparams, raxes),
                param_shardings(rules, params, axes), params, name)
            compared += _same_shardings(
                ref_param_shardings(rrules, rstate, rsaxes),
                param_shardings(rules, state, saxes), state, name)
    print(f"{mesh_name}: {compared} leaves compared")
    assert compared > 0


def test_cache_and_state_spec_helpers_match_reference():
    for name, cfg in ARCHS.items():
        rcfg = REF_ARCHS[name]
        for window in (0, 100):
            _same_specs(rattn.kv_cache_specs(rcfg, 3, 256, window),
                        tattn.kv_cache_specs(cfg, 3, 256, window), name)
            _same_specs(rattn.kv_cache_q_specs(rcfg, 3, 256, window),
                        tattn.kv_cache_q_specs(cfg, 3, 256, window), name)
        for fn in ("mlstm_state_specs", "slstm_state_specs",
                   "rglru_state_specs"):
            _same_specs(getattr(rrec, fn)(rcfg, 3),
                        getattr(trec, fn)(cfg, 3), (name, fn))
        kv8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
        rkv8 = dataclasses.replace(rcfg, kv_cache_dtype="int8")
        _same_axes(rdec.decode_state_axes(rkv8), tdec.decode_state_axes(kv8),
                   name)
        _same_axes(rdec.init_decoder_axes(rcfg), tdec.init_decoder_axes(cfg),
                   name)


def test_logical_to_spec_rules_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    for shape, names in MESHES.values():
        ref_rules = rmesh.production_rules(AbstractMesh(shape, names))
        with tmesh.fake_world(int(np.prod(shape))):
            mesh = tmesh.make_production_mesh(multi_pod=len(shape) == 3,
                                              device_type="cpu")
            rules = tmesh.production_rules(mesh)
            for logical, dims in (
                    (("batch", "seq_cache", "kv_heads", "head_dim"),
                     (64, 4096, 8, 128)),
                    (("batch", "embed"), (64, 2048)),    # 'data' twice
                    (("vocab", "embed"), (151936, 2048)),
                    (("heads", "embed"), (8, 2048)),     # 8 % 16: replicate
                    (("stack", "experts", "embed", "expert_mlp"),
                     (48, 128, 2048, 768)),
                    (("nope", "batch"), (3, 64))):
                want = tuple(ref_logical_to_spec(ref_rules, logical, dims))
                assert logical_to_spec(rules, logical, dims) == want, logical
            cache = NamedSharding(mesh, logical_to_spec(
                rules, ("batch", "seq_cache", "kv_heads"), (64, 4096, 8)))
            batch_dims = [Shard(0)] * (len(shape) - 1)
            assert cache.placements == tuple(batch_dims + [Shard(1)])
            assert NamedSharding(mesh, ()).placements == tuple(
                [Replicate()] * len(shape))
            with pytest.raises(ValueError, match="order"):
                NamedSharding(mesh, (("model", "data"),)).placements
            with pytest.raises(ValueError, match="divide"):
                NamedSharding(mesh, ("model",)).shard_shape((8,))
    # no mesh: nothing is dropped for absence or divisibility
    assert logical_to_spec(DEFAULT_RULES, ("batch", "embed", "mlp"),
                           (3, 5, 7)) == (("pod", "data"), None, "model")


def test_meshes_submeshes_and_host_mesh():
    with tmesh.fake_world(256):
        mesh = tmesh.make_production_mesh(dm_shape=(8, 32),
                                          device_type="cpu")
        assert mesh.shape == (8, 32)
        with pytest.raises(ValueError, match="256"):
            tmesh.make_production_mesh(dm_shape=(8, 16), device_type="cpu")
        mesh = tmesh.make_production_mesh(device_type="cpu")
        subs = tmesh.replica_submeshes(mesh, 4)
        # the reference's split: np.split of the device grid on 'data'
        want = np.split(np.arange(256).reshape(16, 16), 4, axis=0)
        assert [s.mesh.numpy().tolist() for s in subs] == [
            w.tolist() for w in want]
        assert all(s.mesh_dim_names == ("data", "model") for s in subs)
        with pytest.raises(ValueError, match="does not split"):
            tmesh.replica_submeshes(mesh, 3)
        with pytest.raises(ValueError):
            tmesh.replica_submeshes(mesh, 0)
        with pytest.raises(RuntimeError, match="already"):
            with tmesh.fake_world(4):
                pass
    with tmesh.fake_world(4):
        host = tmesh.make_host_mesh(device_type="cpu")
        assert host.shape == (4, 1)
        assert host.mesh_dim_names == ("data", "model")
    assert not torch.distributed.is_initialized()
