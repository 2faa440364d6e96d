"""The arithmetic of the fp32 flash kernels on the tensor cores
(``csrc/flash_f32.cu``, dense up to head dim 256 and schedule-aware up to
128, and ``csrc/flash_f32_bwd.cu`` up to 256, routes ``"tf32x3"`` and
``"tf32x3_256"``), emulated on the CPU and held to the JAX reference.

Each product is three TF32 products: hi = x with its low 13 mantissa bits
cleared, lo = x - hi (read as TF32 too), and hi_a hi_b + hi_a lo_b +
lo_a hi_b.  ``ref.attention_tf32x3`` runs the attention with both products
split so (S, past 128 columns, in two halves of the head dim as the
cluster pairs reduce it); it must agree with the reference's ``flash_attention_bhsd`` (its
Pallas kernel in interpret mode, as the reference's own tests run it) and
with the port's fp32 plain version within the kernels' gate, 1e-4 +
1e-4 |plain|; so must its ragged form against the reference's
schedule-aware kernel (``flash_attention_sched_bhsd``, interpret mode),
and ``ref.attention_bwd_tf32x3``, the backward with each product split so
and, past 128 columns, the head dim's reduction in two halves as the
cluster pairs run it, against ``jax.vjp`` of the reference's
``_attend_flash``.  A single TF32 product (hi_a hi_b alone) misses that
gate, which is why the kernels never use one.  The kernels themselves are held
to the plain version on the card (``tests/test_torch_cuda_kernels.py``,
``tests/test_torch_cuda_train.py``).

Fewer than 12 items: a new test module with more moves the reference's
order-dependent ``tests/test_launch.py`` in pytest-xdist's queue
(ROADMAP.md, "Faults found").
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

from repro.kernels.flash_attention import flash_attention as ref_fa
from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import (attention_bwd_tf32x3,
                                                     attention_ref,
                                                     attention_tf32x3,
                                                     matmul_tf32x3, tf32_hi)

#: the fp32 flash kernels' gate against the plain version
TOL = 1e-4
#: (b, s, h, kvh, window, causal): GQA causal, MQA with a window narrower
#: than a kv tile, non-causal MHA with a ragged tail
CASES = ((1, 300, 4, 2, 0, True), (2, 257, 2, 1, 40, True),
         (1, 200, 2, 2, 0, False))
#: recurrentgemma-2b's local attention (MQA, window 2048) cut to 2 of its
#: 10 heads, with rows past the window
RG_WINDOW_CASE = (1, 2100, 2, 1, 2048, True)


def _inputs(seed, b, s, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((b, s, h, hd), (b, s, kvh, hd),
                               (b, s, kvh, hd)))


def _reference(q, k, v, causal, window):
    """The reference's Pallas kernel in interpret mode on the lanes."""
    out = ref_fa.flash_attention_bhsd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=causal,
        window=window, block_q=128, block_k=128, interpret=True)
    return torch.from_numpy(np.array(out))


def _gate(got, want):
    """max |got - want| / (TOL + TOL |want|): the gate holds below 1."""
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_split_attention_matches_reference_and_plain(hd):
    """At the configs' head dims, causal, windowed, GQA / MQA and
    non-causal (at 256 also recurrentgemma-2b's window of 2048, S in two
    halves of the head dim): the three-term attention within the gate of
    the reference kernel and of the port's plain version (measured at about
    2% of it), and the route that takes such a call on the card."""
    cases = CASES + ((RG_WINDOW_CASE,) if hd > 128 else ())
    for i, (b, s, h, kvh, window, causal) in enumerate(cases):
        q, k, v = _inputs(10 * hd + i, b, s, h, kvh, hd)
        assert fa._check_kernel_inputs("flash_dense", q, k, v) == (
            "tf32x3" if hd <= 128 else "tf32x3_256")
        lanes = fa.broadcast_flatten(q, k, v)
        got = attention_tf32x3(*lanes, causal=causal, window=window)
        plain = attention_ref(*lanes, causal=causal, window=window)
        ref = _reference(*lanes, causal, window)
        assert _gate(got, plain) < 0.1, (hd, i, _gate(got, plain))
        assert _gate(got, ref) < 0.1, (hd, i, _gate(got, ref))
        # the plain version itself sits within the reference's 2e-5
        assert float((plain - ref).abs().max()) <= 2e-5


def test_one_term_product_misses_the_gate():
    """hi_a hi_b alone, a single TF32 product, misses 1e-4 + 1e-4 |plain|
    by a wide margin at every head dim (by about 8x to 19x here)."""
    for hd in (64, 80, 128):
        b, s, h, kvh, window, causal = CASES[0]
        q, k, v = _inputs(hd, b, s, h, kvh, hd)
        lanes = fa.broadcast_flatten(q, k, v)
        plain = attention_ref(*lanes, causal=causal, window=window)
        one = attention_tf32x3(*lanes, causal=causal, window=window, terms=1)
        three = attention_tf32x3(*lanes, causal=causal, window=window)
        assert _gate(one, plain) > 4.0, (hd, _gate(one, plain))
        assert _gate(three, plain) < 0.1


def test_split_is_exact_and_drops_13_bits():
    """hi keeps 19 bits (its low 13 are 0), hi + lo is x exactly, and the
    three-term product of random fp32 matrices is within 2^-18 of the fp64
    product's scale where the single term is not."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32) * 37)
    hi = tf32_hi(x)
    assert not bool((hi.view(torch.int32) & 8191).any())
    assert torch.equal(hi + (x - hi), x)
    assert float((x - hi).abs().max() / x.abs().max()) < 2.0 ** -10
    y = torch.from_numpy(rng.normal(size=(96, 80)).astype(np.float32))
    exact = x.double() @ y.double()
    scale = float((x.double().abs() @ y.double().abs()).max())
    err3 = float((matmul_tf32x3(x, y).double() - exact).abs().max()) / scale
    err1 = float((matmul_tf32x3(x, y, terms=1).double() - exact).abs().max()) \
        / scale
    assert err3 < 2.0 ** -18 < err1, (err3, err1)


def test_split_ragged_attention_matches_reference_sched_kernel():
    """The schedule-aware entry's case (``flash_sched_f32``): ragged lanes
    from a numpy seed (one of length 0, whose rows are 0), causal and
    windowed, GQA and MQA, against the reference's schedule-aware Pallas
    kernel in interpret mode within the gate; such a call takes the
    tensor-core kernel on the card."""
    for i, (b, s, h, kvh, hd, window) in enumerate((
            (2, 300, 4, 2, 128, 0), (3, 200, 2, 1, 64, 70),
            (2, 257, 4, 1, 80, 0))):
        q, k, v = _inputs(100 + i, b, s, h, kvh, hd)
        assert fa.FLASH_SCHED_BY_ROUTE[fa._check_kernel_inputs(
            "flash_sched", q, k, v)] is fa.FLASH_SCHED_F32
        lens = np.random.default_rng(i).integers(1, s + 1, size=b)
        lens[0] = 0
        lane_lens = np.repeat(lens, h)
        lanes = fa.broadcast_flatten(q, k, v)
        got = attention_tf32x3(*lanes, window=window, kv_lens=lane_lens)
        ref = ref_fa.flash_attention_sched_bhsd(
            *(jnp.asarray(x.numpy()) for x in lanes), schedule="fac2",
            kv_lens=lane_lens, window=window, block_q=128, block_k=128,
            interpret=True)
        ref = torch.from_numpy(np.array(ref))
        assert _gate(got, ref) < 0.1, (i, _gate(got, ref))
        assert not bool(got[:h].any()) and not bool(ref[:h].any())


def test_split_backward_at_head_dim_256_matches_reference_autodiff():
    """recurrentgemma-2b's local attention in small (MQA 10 / 1, hd 256,
    a window narrower than s) and an hd of 200: dQ, dK and dV with every
    product three TF32 products and S, dP reduced in two halves of the head
    dim (the cluster pairs of ``flash_f32_bwd256_*``) within the gate of
    ``jax.vjp`` of the reference's ``_attend_flash``; such a backward takes
    the tensor cores' cluster pairs on the card, as its forward does."""
    rng = np.random.default_rng(28)
    for b, s, h, kvh, hd, window in ((1, 48, 10, 1, 256, 16),
                                     (2, 40, 4, 2, 200, 0)):
        q, k, v, do = (rng.normal(size=(b, s, n, hd)).astype(np.float32)
                       for n in (h, kvh, kvh, h))
        _, vjp = jax.vjp(lambda q_, k_, v_: ref_attn._attend_flash(
            q_, k_, v_, None, window), *map(jnp.asarray, (q, k, v)))
        want = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(do))]
        tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
        assert fa._check_kernel_inputs("flash_dense", tq, tk,
                                       tv) == "tf32x3_256"
        lanes = fa.broadcast_flatten(tq, tk, tv)
        dof = tdo.permute(0, 2, 1, 3).reshape(b * h, s, hd)
        dq, dk, dv = attention_bwd_tf32x3(*lanes, dof, window=window)
        dq = dq.reshape(b, h, s, hd).permute(0, 2, 1, 3)
        dk, dv = (x.reshape(b, kvh, h // kvh, s, hd).sum(2)
                  .permute(0, 2, 1, 3) for x in (dk, dv))
        for name, got, ref in zip("qkv", (dq, dk, dv), want):
            assert got.shape == ref.shape
            assert _gate(got, ref) < 0.1, (name, hd, _gate(got, ref))
