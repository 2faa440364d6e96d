"""The port's grouped expert-tile matmul (``repro_torch.kernels.
grouped_matmul``) on CPU tensors against the JAX reference's Pallas kernel
in interpret mode, with the expert weights of ``repro.models.moe.init_moe``
carried over by ``repro_torch.convert.params_from_jax``.

Tolerance: atol 1e-4 in fp32, the reference's own against its oracle
(tests/test_kernel_sched.py).  Outputs are identical for every schedule,
the recorder sees the reference's telemetry, and a CPU tensor never
reaches a CUDA launch.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.configs import ARCHS, smoke_config
from repro.kernels.grouped_matmul import ops as ref_ops
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as jax_gmm_ref
from repro.models.moe import init_moe
from repro_torch.convert import flatten_tree, params_from_jax
from repro_torch.core import REGISTRY, LoopRecorder
from repro_torch.kernels import _build
from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

ATOL = 1e-4
SPEC_VARIANTS = tuple(REGISTRY) + ("fac2,4", "gss,2", "ss,8", "static,4")
E, C, BM = 4, 16, 8
ROWS = np.array([16, 4, 9, 12])


@pytest.fixture(scope="module")
def moe_params():
    cfg = smoke_config(ARCHS["qwen3-moe-30b-a3b"])
    params, _ = init_moe(jax.random.key(0), cfg)
    host = jax.tree_util.tree_map(np.asarray, params)
    return host, params_from_jax(host, device="cpu")


@pytest.fixture(scope="module")
def xe(moe_params):
    d = moe_params[0]["wi"].shape[1]
    return np.random.default_rng(11).normal(size=(E, C, d)).astype(np.float32)


def _jax(x, w, **kw):
    return np.asarray(ref_ops.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                             block_rows=BM, interpret=True,
                                             **kw))


def _port(x, w, **kw):
    return grouped_matmul(torch.from_numpy(x), w, block_rows=BM, **kw).numpy()


def test_params_from_jax_keeps_the_expert_stacks(moe_params):
    host, tp = moe_params
    assert set(tp) == set(host)
    for name in ("wi", "wo", "router", "router_bias"):
        assert tp[name].device.type == "cpu"
        np.testing.assert_array_equal(tp[name].numpy(), host[name])
    wi = tp["wi"]
    assert wi.shape[0] == E and wi.dtype == torch.float32


def test_params_from_jax_paths_and_dtype():
    tree = {"layers": [{"w": np.ones((2, 3), np.float32)},
                       {"w": np.zeros((1,), np.int32)}], "b": np.float32(2)}
    assert sorted(flatten_tree(tree)) == ["b", "layers/0/w", "layers/1/w"]
    out = params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    assert out["layers/0/w"].dtype == torch.bfloat16
    assert out["layers/1/w"].dtype == torch.int32     # integers keep their type
    bf = params_from_jax({"x": np.asarray(jnp.ones((2,), jnp.bfloat16))},
                         device="cpu")
    assert bf["x"].dtype == torch.bfloat16 and bf["x"].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("which", ("wi", "wo"))
def test_identity_order_matches_jax(moe_params, xe, which):
    host, tp = moe_params
    x = xe if which == "wi" else xe[:, :, :host["wo"].shape[1]].copy()
    np.testing.assert_allclose(_port(x, tp[which]), _jax(x, host[which]),
                               atol=ATOL)


@pytest.mark.parametrize("technique", SPEC_VARIANTS)
def test_identical_for_every_spec_and_matches_jax(moe_params, xe, technique):
    host, tp = moe_params
    out = _port(xe, tp["wi"], schedule=technique, expert_rows=ROWS)
    assert np.array_equal(out, _port(xe, tp["wi"]))
    if technique in ("fac2", "awf_b", "dls_steal"):
        np.testing.assert_allclose(
            out, _jax(xe, host["wi"], schedule=technique, expert_rows=ROWS),
            atol=ATOL)


def test_explicit_tile_order_and_records_match_jax(moe_params, xe):
    host, tp = moe_params
    order = np.random.default_rng(1).permutation(E * C // BM)
    np.testing.assert_allclose(
        _port(xe, tp["wi"], tile_order=torch.from_numpy(order)),
        _jax(xe, host["wi"], tile_order=jnp.asarray(order)), atol=ATOL)
    rec_p, rec_j = LoopRecorder(), ref_core.LoopRecorder()
    for spec in ("fac2,2", "ss"):
        _port(xe, tp["wi"], schedule=spec, expert_rows=ROWS, recorder=rec_p)
        _jax(xe, host["wi"], schedule=spec, expert_rows=ROWS, recorder=rec_j)
    assert [r.to_dict() for r in rec_p.records] == [
        r.to_dict() for r in rec_j.records]
    assert [r.instance for r in rec_p.records] == [0, 1]


def test_plain_versions_match_jax_oracle(moe_params, xe):
    host, tp = moe_params
    t = E * C // BM
    tiles = xe.reshape(t, BM, -1)
    te = np.random.default_rng(3).integers(0, E, t).astype(np.int32)
    want = np.asarray(jax_gmm_ref(jnp.asarray(tiles), jnp.asarray(host["wi"]),
                                  jnp.asarray(te)))
    x = torch.from_numpy(tiles)
    for got in (gm.grouped_matmul_tiles(x, tp["wi"], torch.from_numpy(te)),
                grouped_matmul_ref(x, tp["wi"], torch.from_numpy(te))):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_schedule_and_order_are_exclusive(moe_params, xe):
    with pytest.raises(ValueError, match="not both"):
        _port(xe, moe_params[1]["wi"], tile_order=np.arange(8),
              schedule="fac2")


def test_capacity_must_divide_into_tiles(moe_params):
    x = torch.zeros(E, 12, moe_params[1]["wi"].shape[1])
    with pytest.raises(AssertionError):
        grouped_matmul(x, moe_params[1]["wi"], block_rows=BM)


def test_span_bounds_split_contiguously():
    for n, p in ((512, 132), (7, 3), (3, 8), (0, 4)):
        b = gm.span_bounds(n, p)
        assert b.shape == (p + 1,) and b[0] == 0 and b[-1] == n
        assert (np.diff(b) >= 0).all() and np.diff(b).max(initial=0) <= -(-n // p)


def test_cpu_tensors_never_reach_a_launch(monkeypatch, moe_params, xe):
    def refuse(self, *args):
        raise AssertionError("a CPU tensor reached a CUDA launch")

    monkeypatch.setattr(_build.Kernel, "launch", refuse)
    before = gm.GMM.launches
    _port(xe, moe_params[1]["wi"], schedule="fac2", expert_rows=ROWS)
    _port(xe, moe_params[1]["wi"])
    assert gm.GMM.launches == before
