"""The port's flash attention (``repro_torch.kernels.flash_attention``) on
CPU tensors against the JAX reference's Pallas kernels in interpret mode.

On a CPU tensor the port computes the plain PyTorch version; it must
match the reference kernel in fp32 within atol 2e-5 (the reference's own
tolerance against its oracle, tests/test_kernel_sched.py), be identical
for every schedule, record the same plan telemetry, and never reach a CUDA
launch.  The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
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
from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.core import REGISTRY, LoopRecorder
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

ATOL = 2e-5
SPEC_VARIANTS = tuple(REGISTRY) + ("fac2,4", "gss,2", "ss,8", "static,4")


def _inputs(seed, b, s, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))


def _jax(q, k, v, **kw):
    out = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), interpret=True, **kw)
    return np.asarray(out)


def _port(q, k, v, **kw):
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    return out.numpy()


Q, K, V = _inputs(11, 1, 160, 2, 1, 32)


@pytest.fixture(scope="module")
def port_baseline():
    return _port(Q, K, V, block_q=64, block_k=64, schedule="static")


@pytest.fixture(scope="module")
def jax_baseline():
    return _jax(Q, K, V, block_q=64, block_k=64, schedule="static")


def test_plain_matches_jax_kernel(port_baseline, jax_baseline):
    np.testing.assert_allclose(port_baseline, jax_baseline, atol=ATOL)


@pytest.mark.parametrize("technique", SPEC_VARIANTS)
def test_identical_for_every_spec(technique, port_baseline):
    out = _port(Q, K, V, block_q=64, block_k=64, schedule=technique)
    assert np.array_equal(out, port_baseline)


@pytest.mark.parametrize("technique", ("static", "ss", "gss", "fac2"))
def test_ragged_kv_lens_match_jax(technique):
    lens = np.array([97])
    rec_p, rec_j = LoopRecorder(), ref_core.LoopRecorder()
    out = _port(Q, K, V, block_q=64, block_k=64, schedule=technique,
                kv_lens=lens, recorder=rec_p)
    want = _jax(Q, K, V, block_q=64, block_k=64, schedule=technique,
                kv_lens=lens, recorder=rec_j)
    np.testing.assert_allclose(out, want, atol=ATOL)
    assert [r.to_dict() for r in rec_p.records] == [
        r.to_dict() for r in rec_j.records]
    assert rec_p.records[0].loop == "flash_kv"


@pytest.mark.parametrize("case", [
    # b, s, h, kvh, hd, block, window, lens, schedule
    (2, 130, 4, 2, 32, 32, 0, [33, 130], "fac2"),
    (1, 160, 2, 1, 32, 32, 48, None, "tap"),
    (3, 72, 4, 1, 16, 16, 0, [0, 72, 5], "awf_b"),
    (2, 64, 2, 2, 32, 64, 20, [64, 40], "dls_steal"),
])
def test_gqa_window_ragged_match_jax(case):
    b, s, h, kvh, hd, blk, window, lens, sched = case
    q, k, v = _inputs(b * s + h, b, s, h, kvh, hd)
    lens = None if lens is None else np.asarray(lens)
    kw = dict(block_q=blk, block_k=blk, window=window, schedule=sched,
              kv_lens=lens, sched_p=3)
    np.testing.assert_allclose(_port(q, k, v, **kw), _jax(q, k, v, **kw),
                               atol=ATOL)


def test_dense_cpu_path_matches_jax_dense_kernel():
    kw = dict(block_q=64, block_k=64)
    np.testing.assert_allclose(_port(Q, K, V, **kw), _jax(Q, K, V, **kw),
                               atol=ATOL)
    np.testing.assert_allclose(_port(Q, K, V, window=40, **kw),
                               _jax(Q, K, V, window=40, **kw), atol=ATOL)


@pytest.mark.parametrize("causal", (True, False))
def test_oracle_matches_jax_oracle(causal):
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(3, 50, 16)).astype(np.float32)
               for _ in range(3))
    lens = np.array([50, 7, 0])
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, window=9,
                        kv_lens=lens).numpy()
    want = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        window=9, kv_lens=lens))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert not got[2].any()    # a lane with no valid KV is all zeros


def test_plain_version_chunks_lanes_exactly():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(5, 40, 8)).astype(np.float32))
               for _ in range(3))
    lens = np.array([40, 3, 17, 0, 22])
    whole = attention_ref(q, k, v, kv_lens=lens)
    chunked = fa.flash_attention_sched_plain(q, k, v, kv_lens=lens,
                                             lane_chunk=2)
    assert torch.equal(whole, chunked)


def test_bhsd_entry_matches_jax():
    q, k, v = (x[:, :, 0].repeat(2, axis=0) for x in (Q, K, V))  # (2, s, hd)
    lens = np.array([160, 61])
    got = fa.flash_attention_sched_bhsd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        schedule="gss", kv_lens=lens, block_q=64, block_k=64).numpy()
    from repro.kernels.flash_attention.flash_attention import (
        flash_attention_sched_bhsd as jax_bhsd)
    want = np.asarray(jax_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               schedule="gss", kv_lens=lens, block_q=64,
                               block_k=64, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_sched_wide_head_dims_match_jax_and_pass_the_kernel_check():
    """The schedule-aware path at the head dims of stablelm-3b (80) and
    recurrentgemma-2b (256): ragged lens and a window, against the
    reference kernel in interpret mode.  Then the check the CUDA launcher
    runs first, on bf16 CPU tensors: every multiple of 8 up to 256 passes,
    20 and 264 raise."""
    for hd, lens, window in ((80, [33, 130], 40), (256, [130, 71], 0)):
        q, k, v = _inputs(hd, 2, 130, 4, 1, hd)
        kw = dict(block_q=32, block_k=32, window=window, schedule="fac2",
                  kv_lens=np.asarray(lens), sched_p=3)
        np.testing.assert_allclose(_port(q, k, v, **kw), _jax(q, k, v, **kw),
                                   atol=ATOL)
    for hd in range(8, 257, 8):
        x = torch.zeros(1, 16, 2, hd, dtype=torch.bfloat16)
        fa._check_kernel_inputs("flash_sched", x, x[:, :, :1], x[:, :, :1])
    for hd in (20, 264):
        x = torch.zeros(1, 16, 2, hd, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa._check_kernel_inputs("flash_sched", x, x, x)


def test_kv_lens_require_schedule():
    with pytest.raises(ValueError, match="kv_lens requires schedule"):
        _port(Q, K, V, kv_lens=np.array([100]))


def test_cpu_tensors_never_reach_a_launch(monkeypatch):
    def refuse(self, *args):
        raise AssertionError("a CPU tensor reached a CUDA launch")

    monkeypatch.setattr(_build.Kernel, "launch", refuse)
    before = fa.FLASH_SCHED.launches
    _port(Q, K, V, block_q=64, block_k=64, schedule="fac2",
          kv_lens=np.array([90]))
    _port(Q, K, V, block_q=64, block_k=64)
    assert fa.FLASH_SCHED.launches == before


def test_mixed_devices_raise():
    q = torch.zeros(1, 8, 1, 8)
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(q, q.to("meta"), q, schedule="fac2")


# ---------------------------------------------------------------------------
# the dense kernel (schedule=None): the sweeps of tests/test_kernels.py
# ---------------------------------------------------------------------------

# the reference's own tolerances against its oracle (tests/test_kernels.py):
# 2e-5 in fp32; 3e-2 in bf16, where both sides round an fp32 result to bf16
DENSE_TOL = {np.float32: 2e-5, "bfloat16": 3e-2}


def _dense_both(q, k, v, dtype=np.float32, **kw):
    if dtype == "bfloat16":
        jx = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
        tx = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    else:
        jx = [jnp.asarray(x) for x in (q, k, v)]
        tx = [torch.from_numpy(x) for x in (q, k, v)]
    want = np.asarray(ref_ops.flash_attention(*jx, interpret=True, **kw),
                      np.float32)
    got = flash_attention(*tx, **kw).float().numpy()
    return got, want


@pytest.mark.parametrize("shape", [
    (1, 128, 2, 2, 64),     # MHA, exact blocks
    (2, 300, 4, 2, 64),     # GQA, ragged seq
    (1, 513, 2, 1, 128),    # MQA, off-by-one seq
    (1, 64, 8, 4, 32),      # small head_dim
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dense_matches_jax_kernel(shape, dtype):
    got, want = _dense_both(*_inputs(sum(shape), *shape), dtype=dtype,
                            block_q=128, block_k=128)
    tol = DENSE_TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [32, 128])
def test_dense_sliding_window_matches_jax_kernel(window):
    """GQA at head dim 64, then windowed MQA at the head dims that
    stablelm-3b (80) and recurrentgemma-2b (256) give the dense kernel
    (looped here: ROADMAP.md, faults, keeps this file's item count)."""
    for h, kvh, hd in ((2, 2, 64), (4, 1, 80), (4, 1, 256)):
        got, want = _dense_both(*_inputs(5, 1, 300, h, kvh, hd),
                                window=window, block_q=64, block_k=64)
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("causal", (True, False))
def test_dense_causality_matches_jax_kernel(causal):
    """Causal and not, with a window of 20, at head dims 32, 80 and 256."""
    for hd in (32, 80, 256):
        got, want = _dense_both(*_inputs(6, 2, 100, 4, 1, hd), causal=causal,
                                window=20, block_q=32, block_k=32)
        np.testing.assert_allclose(got, want, atol=ATOL)
    got, want = _dense_both(*_inputs(6, 1, 200, 2, 2, 80), causal=causal,
                            block_q=64, block_k=64)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("blocks", [(64, 128), (128, 64), (256, 256)])
def test_dense_block_shape_sweep_matches_jax_kernel(blocks):
    bq, bk = blocks
    got, want = _dense_both(*_inputs(7, 1, 384, 2, 2, 64), block_q=bq,
                            block_k=bk)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dense_matches_model_flash_path():
    """The model's plain flash path and the dense kernel's agree, as the
    reference's tests/test_kernels.py holds the two."""
    import dataclasses
    from repro.configs import ARCHS, smoke_config
    from repro.models.attention import _attend_flash as jax_attend_flash
    from repro_torch.models.attention import _attend_flash

    cfg = dataclasses.replace(smoke_config(ARCHS["qwen3-4b"]),
                              compute_dtype="float32")
    q, k, v = _inputs(8, 2, 256, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    model_out = _attend_flash(*map(torch.from_numpy, (q, k, v)), cfg,
                              window=0, block=64)
    kern_out = _port(q, k, v, block_q=64, block_k=64)
    np.testing.assert_allclose(model_out.numpy(), kern_out, atol=ATOL)
    np.testing.assert_allclose(
        model_out.numpy(),
        np.asarray(jax_attend_flash(*map(jnp.asarray, (q, k, v)), cfg,
                                    window=0, block=64)), atol=ATOL)


def test_dense_bhsd_entry_matches_jax():
    from repro.kernels.flash_attention.flash_attention import (
        flash_attention_bhsd as jax_bhsd)

    q, k, v = (x[:, :, 0].repeat(3, axis=0) for x in (Q, K, V))  # (3, s, hd)
    got = fa.flash_attention_bhsd(*map(torch.from_numpy, (q, k, v)),
                                  window=50, block_q=64, block_k=32).numpy()
    want = np.asarray(jax_bhsd(*map(jnp.asarray, (q, k, v)), window=50,
                               block_q=64, block_k=32, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert fa.FLASH_DENSE.name == "flash_dense"
    assert _build.KERNELS["flash_dense"] is fa.FLASH_DENSE
