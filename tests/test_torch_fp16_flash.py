"""The arithmetic of the fp16 flash kernels on the tensor cores
(``csrc/flash_dense.cu``, ``csrc/flash_sched.cu`` and
``csrc/flash_dense_bwd.cu`` at T = __half, route ``"wgmma"``), emulated on
the CPU and held to the JAX reference.

The reference casts q, k and v to fp32, so its products, its P and (under
autodiff) its dS and D are fp32.  The kernels feed wgmma fp16 operands
with fp32 accumulators: the forward passes P as hi + lo, two fp16 terms;
the backward passes P and dS the same way and forms D from the fp16 output
plus its rounding residual o_lo, which the forward writes.
``ref.attention_f16`` and ``ref.attention_bwd_f16`` run those roundings in
fp32; they must agree with the reference's ``flash_attention_bhsd`` (its
Pallas kernel in interpret mode, as the reference's own tests run it) and
with ``jax.vjp`` of its ``_attend_flash`` (causal; a non-causal case
against the same attention in jnp), and the ragged forward with the
reference's schedule-aware kernel (``flash_attention_sched_bhsd``,
interpret mode) and the port's plain schedule-aware version, within the
fp16 gate,
2^-10 + 2^-10 |plain|, on inputs drawn from a numpy seed and rounded to
fp16, at head dims 64, 80, 128 and 256 with GQA, MQA, windows and
non-causal cases.  The tests print the share of the gate each case uses.
A single fp16 rounding of P or of dS, or D from the fp16 output alone,
uses more than half of the gate at a long row, which is why the kernels
do neither.  The kernels themselves are held to the plain version on the
card (``tests/test_torch_cuda_kernels.py``,
``tests/test_torch_cuda_train.py``).

Fewer than 12 items: a new test module with more moves the reference's
order-dependent ``tests/test_launch.py`` in pytest-xdist's queue
(ROADMAP.md, "Faults found").
"""

import math

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
from repro_torch.kernels.flash_attention.ref import (attention_bwd_f16,
                                                     attention_f16,
                                                     attention_ref,
                                                     round_f16, split_f16)

#: the fp16 gate: 2^-10 + 2^-10 |plain| (two fp16 rounding steps)
TOL = 2.0 ** -10
#: (b, s, h, kvh, window, causal) at each head dim: GQA causal with a
#: ragged tail, MQA with a window narrower than a kv tile, non-causal MHA
CASES = ((1, 300, 4, 2, 0, True), (2, 257, 2, 1, 40, True),
         (1, 200, 2, 2, 0, False))


def _f16(rng, shape, scale=1.0):
    """Normal values of ``shape`` rounded to fp16, as an fp16 tensor."""
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float16))


def _gate(got, want):
    """max |got - want| / (TOL + TOL |want|): the gate holds below 1."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


def _dense_noncausal(q, k, v):
    """fp32 softmax attention over every column in jnp, model layout: the
    function of the reference's non-causal Pallas kernel, which its
    ``_attend_flash`` (causal only) does not cover."""
    h = q.shape[2]
    k, v = (jnp.repeat(x, h // x.shape[2], axis=2) for x in (k, v))
    p = jax.nn.softmax(jnp.einsum("bshd,bthd->bhst", q, k)
                       / math.sqrt(q.shape[-1]), axis=-1)
    return jnp.einsum("bhst,bthd->bshd", p, v)


def _vjp(q, k, v, do, causal, window):
    """dQ, dK, dV by ``jax.vjp`` in fp32 at the fp16 values of q, k, v and
    do (model layout): of the reference's ``_attend_flash`` where causal,
    else of :func:`_dense_noncausal`."""
    fn = ((lambda q_, k_, v_: ref_attn._attend_flash(q_, k_, v_, None,
                                                      window))
          if causal else _dense_noncausal)
    _, vjp = jax.vjp(fn, *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))
    return [torch.from_numpy(np.array(x))
            for x in vjp(jnp.asarray(do.float().numpy()))]


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_fp16_attention_matches_reference_and_plain(hd):
    """The fp16 forward (P as hi + lo, one rounding of the output) within
    the gate of the reference kernel in interpret mode and of the port's
    plain version, with the route that takes such a call on the card."""
    for i, (b, s, h, kvh, window, causal) in enumerate(CASES):
        rng = np.random.default_rng(10 * hd + i)
        q, k, v = (_f16(rng, (b, s, n, hd)) for n in (h, kvh, kvh))
        assert fa._check_kernel_inputs("flash_dense", q, k, v) == "wgmma"
        lanes = fa.broadcast_flatten(q, k, v)
        got, o_lo, _ = attention_f16(*lanes, causal=causal, window=window)
        assert got.dtype == torch.float16
        plain = attention_ref(*(x.float() for x in lanes), causal=causal,
                              window=window)
        ref = torch.from_numpy(np.array(ref_fa.flash_attention_bhsd(
            *(jnp.asarray(x.float().numpy()) for x in lanes), causal=causal,
            window=window, block_q=128, block_k=128, interpret=True)))
        shares = _gate(got, plain), _gate(got, ref)
        print(f"fp16 forward hd {hd} case {i}: gate share {shares[0]:.3f} "
              f"of plain, {shares[1]:.3f} of the reference")
        assert max(shares) < 0.6, (hd, i, shares)
        # out + o_lo keeps the fp32 output to about 2^-21 of its scale
        assert float((got.float() + o_lo.float() - plain).abs().max()) \
            <= 2.0 ** -18 * (1 + float(plain.abs().max()))


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_fp16_backward_matches_reference_autodiff(hd):
    """dQ, dK and dV with P and dS as hi + lo and D from the output plus
    o_lo, within the gate of ``jax.vjp`` of the reference's
    ``_attend_flash`` (GQA, MQA with a window) and, non-causal MHA, of the
    same attention over every column in jnp; such a backward runs
    ``flash_dense_bwd`` on the card."""
    for i, (b, s, h, kvh, window, causal) in enumerate(CASES):
        rng = np.random.default_rng(20 * hd + i)
        q, k, v, do = (_f16(rng, (b, s, n, hd)) for n in (h, kvh, kvh, h))
        assert fa.flash_route(q.dtype, hd) == "wgmma"
        got = attention_bwd_f16(q, k, v, do, causal=causal, window=window)
        want = _vjp(q, k, v, do, causal, window)
        for name, g, w in zip("qkv", got, want):
            assert g.shape == w.shape and g.dtype == torch.float16
            share = _gate(g, w)
            print(f"fp16 backward hd {hd} case {i} d{name}: gate share "
                  f"{share:.3f}")
            assert share < 0.6, (name, hd, i, share)


def test_fp16_ragged_attention_matches_reference_sched_kernel():
    """The schedule-aware entry's case in fp16 (``flash_sched`` at T =
    __half): ragged lanes from a numpy seed (one of length 0, whose rows
    are 0), causal and windowed, GQA and MQA, at head dims 128, 64, 80 and
    256, P as hi + lo, within the gate of the reference's schedule-aware
    Pallas kernel in interpret mode and of the port's plain schedule-aware
    version; such a call takes ``flash_sched`` on the card."""
    for i, (b, s, h, kvh, hd, window) in enumerate((
            (2, 300, 4, 2, 128, 0), (3, 200, 2, 1, 64, 70),
            (2, 257, 4, 1, 80, 0), (2, 200, 2, 1, 256, 40))):
        rng = np.random.default_rng(30 + i)
        q, k, v = (_f16(rng, (b, s, n, hd)) for n in (h, kvh, kvh))
        assert fa.FLASH_SCHED_BY_ROUTE[fa._check_kernel_inputs(
            "flash_sched", q, k, v)] is fa.FLASH_SCHED
        lens = rng.integers(1, s + 1, size=b)
        lens[0] = 0
        lane_lens = np.repeat(lens, h)
        lanes = fa.broadcast_flatten(q, k, v)
        got, _, _ = attention_f16(*lanes, window=window, kv_lens=lane_lens)
        assert got.dtype == torch.float16
        plain = fa.flash_attention_sched_plain(
            *(x.float() for x in lanes), kv_lens=lane_lens, window=window)
        ref = torch.from_numpy(np.array(ref_fa.flash_attention_sched_bhsd(
            *(jnp.asarray(x.float().numpy()) for x in lanes),
            schedule="fac2", kv_lens=lane_lens, window=window, block_q=128,
            block_k=128, interpret=True)))
        shares = _gate(got, plain), _gate(got, ref)
        print(f"fp16 ragged hd {hd} case {i}: gate share {shares[0]:.3f} "
              f"of plain, {shares[1]:.3f} of the reference")
        assert max(shares) < 0.6, (hd, i, shares)
        assert not bool(got[:h].any()) and not bool(ref[:h].any())


def test_one_rounding_uses_more_than_half_the_gate():
    """At a row of 1024 columns (hd 128, a GQA group of 4, causal), against
    the fp64 backward: one fp16 rounding of P costs dV more than half the
    gate on its own, one of dS costs dK more than half, and D from the fp16
    output alone costs dK more than half; with the kernels' splits and
    o_lo the whole backward stays within its outputs' rounding (under 0.5
    of the gate)."""
    rng = np.random.default_rng(29)
    b, s, h, kvh, hd = 1, 1024, 4, 1, 128
    q, k, v, do = (_f16(rng, (b, s, n, hd)) for n in (h, kvh, kvh, h))
    # fp64 gradients of the fp16 values
    qd, kd, vd, dod = (x.double().permute(0, 2, 1, 3)
                       .repeat_interleave(h // x.shape[2], dim=1)
                       for x in (q, k, v, do))
    sc = 1 / math.sqrt(hd)
    live = torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.softmax(torch.where(live, qd @ kd.transpose(-1, -2) * sc,
                                  -torch.inf), dim=-1)
    ds = p * (dod @ vd.transpose(-1, -2)
              - (dod * (p @ vd)).sum(-1, keepdim=True))
    exact = [x.reshape(b, kvh if n else h, -1, s, hd).sum(2)
             .permute(0, 2, 1, 3) for n, x in enumerate(
                 (ds @ kd * sc, ds.transpose(-1, -2) @ qd * sc,
                  p.transpose(-1, -2) @ dod))]

    def grads(**kw):
        return [x.double() for x in attention_bwd_f16(q, k, v, do, **kw)]

    def own(a, b_, i):
        """The share of the gate the difference of two runs takes."""
        diff = (a[i] - b_[i]).abs()
        return float((diff / (TOL + TOL * exact[i].abs())).max())

    kernel = grads()
    one = grads(split=False)
    no_res = grads(residual=False)
    shares = {"P (dV)": own(one, kernel, 2), "dS (dK)": own(one, kernel, 1),
              "D (dK)": own(no_res, kernel, 1),
              "kernels": max(_gate(g, e) for g, e in zip(kernel, exact))}
    print("fp16 backward, gate shares:", {n: round(x, 3)
                                          for n, x in shares.items()})
    assert shares["P (dV)"] > 0.5 and shares["dS (dK)"] > 0.5, shares
    assert shares["D (dK)"] > 0.5 and shares["kernels"] < 0.5, shares


def test_split_keeps_22_bits_and_flushes_below_2_to_the_minus_25():
    """hi + lo of fp16 keeps x within 2^-22 |x| while lo is normal and
    within 2^-25 absolute below (p is at most 1 in the kernels), where one
    fp16 rounding misses by up to 2^-11 |x|; past 65504 a rounding is inf,
    the range dS stays within (see csrc/flash_dense_bwd.cu)."""
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.uniform(2.0 ** -3, 1.0, size=4096)
                         .astype(np.float32))
    assert float(((split_f16(x) - x).abs() / x).max()) <= 2.0 ** -22
    assert float(((round_f16(x) - x).abs() / x).max()) > 2.0 ** -13
    small = torch.from_numpy(rng.uniform(0.0, 2.0 ** -3, size=4096)
                             .astype(np.float32))
    assert float((split_f16(small) - small).abs().max()) <= 2.0 ** -25
    assert float(split_f16(torch.tensor([2.0 ** -26]))) == 0.0
    assert bool(torch.isinf(round_f16(torch.tensor([65520.0]))).all())
    assert float(round_f16(torch.tensor([65504.0]))) == 65504.0
