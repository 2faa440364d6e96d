"""Plain PyTorch oracle for the flash-attention kernels (fp32 math), and
emulations, for the tests, of the fp32 tensor-core kernels' three-term
TF32 split and of the fp16 tensor-core kernels' roundings."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  kv_lens: Optional[Sequence[int]] = None):
    """q, k, v: (bh, s, hd) -> (bh, s, hd), fp32 math.

    ``kv_lens`` (per-lane valid KV lengths, shape (bh,)) masks columns at
    or beyond each lane's length — the ragged-decode oracle for the
    schedule-aware kernel.  Rows with every column masked return 0.
    """
    bh, s, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bsd,btd->bst", q.float(), k.float()) * scale
    i = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window > 0:
        mask &= (i[:, None] - i[None, :]) < window
    mask = mask[None].expand(bh, s, s)
    if kv_lens is not None:
        lens = torch.as_tensor(np.asarray(kv_lens, np.int64), device=q.device)
        mask = mask & (i[None, None, :] < lens[:, None, None])
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # fully-masked rows (ragged padding): uniform softmax garbage -> 0
    alive = mask.any(dim=-1, keepdim=True)
    probs = torch.where(alive, probs, 0.0)
    out = torch.einsum("bst,btd->bsd", probs, v.float())
    return out.to(q.dtype)


def tf32_hi(x):
    """fp32 ``x`` with its low 13 mantissa bits cleared: the 19 bits that
    the tensor cores' TF32 path reads of an fp32 word."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def matmul_tf32x3(a, b, *, terms: int = 3):
    """``a @ b`` in fp32 as ``csrc/flash_f32.cu`` computes it: hi = tf32_hi
    of each operand, lo = the rest (read as TF32 too), and
    hi_a hi_b + hi_a lo_b + lo_a hi_b; ``terms=1`` keeps hi_a hi_b alone
    (a single TF32 product, which the kernels never use)."""
    ah, bh = tf32_hi(a), tf32_hi(b)
    out = ah @ bh
    if terms == 3:
        out = out + (ah @ tf32_hi(b - bh) + tf32_hi(a - ah) @ bh)
    return out


def _mask(s: int, device, *, causal: bool, window: int, kv_lens=None):
    """(lanes or 1, s, s) bool: the live (row, column) pairs."""
    i = torch.arange(s, device=device)
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window > 0:
        mask &= (i[:, None] - i[None, :]) < window
    mask = mask[None]
    if kv_lens is not None:
        lens = torch.as_tensor(np.asarray(kv_lens, np.int64), device=device)
        mask = mask & (i[None, None, :] < lens[:, None, None])
    return mask


def matmul_halves(a, b, *, terms: int = 3, width: int = 128):
    """``a @ b`` reduced over a dim wider than ``width`` as the cluster
    pairs of ``csrc/flash_f32.cu`` and ``csrc/flash_f32_bwd.cu`` do at head
    dims 136-256: the three-term product of each ``width``-column half,
    then their sum."""
    if a.shape[-1] <= width:
        return matmul_tf32x3(a, b, terms=terms)
    return (matmul_tf32x3(a[..., :width], b[..., :width, :], terms=terms)
            + matmul_tf32x3(a[..., width:], b[..., width:, :], terms=terms))


def attention_tf32x3(q, k, v, *, causal: bool = True, window: int = 0,
                     kv_lens: Optional[Sequence[int]] = None,
                     terms: int = 3):
    """:func:`attention_ref` with both products split as
    ``csrc/flash_f32.cu`` splits them: S = Q K^T through
    :func:`matmul_halves` (in two halves of the head dim past 128 columns,
    as the cluster pairs reduce it), P V through :func:`matmul_tf32x3`:
    q, k, v (bh, s, hd) fp32 -> (bh, s, hd), rows with no live column 0.
    Used by the tests only, to hold the split's arithmetic to the
    reference on the CPU."""
    bh, s, hd = q.shape
    scores = matmul_halves(q.float(), k.float().transpose(1, 2),
                           terms=terms) / math.sqrt(hd)
    mask = _mask(s, q.device, causal=causal, window=window, kv_lens=kv_lens)
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    return matmul_tf32x3(probs, v.float(), terms=terms)


def attention_bwd_tf32x3(q, k, v, do, *, causal: bool = True,
                         window: int = 0, terms: int = 3):
    """(dq, dk, dv) of the dense function at q, k, v, do (bh, s, hd) fp32,
    as ``csrc/flash_f32_bwd.cu`` computes them: the forward's log-sum-exp
    lse, P = exp(S - lse), D = rowsum(dO o O) in fp32, and the five
    products through :func:`matmul_halves` (S = Q K^T, dP = dO V^T over
    the head dim in halves past 128 columns; dV = P^T dO, dQ = dS K,
    dK = dS^T Q), dS = P o (dP - D).  Used by the tests only."""
    bh, s, hd = q.shape
    q, k, v, do = (x.float() for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(hd)
    mask = _mask(s, q.device, causal=causal, window=window)
    scores = torch.where(mask, matmul_halves(q, k.transpose(1, 2),
                                             terms=terms) * scale, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - lse), 0.0)
    out = matmul_tf32x3(p, v, terms=terms)
    delta = (do * out).sum(dim=-1, keepdim=True)
    dp = matmul_halves(do, v.transpose(1, 2), terms=terms)
    ds = p * (dp - delta)
    dv = matmul_tf32x3(p.transpose(1, 2), do, terms=terms)
    dq = matmul_tf32x3(ds, k, terms=terms) * scale
    dk = matmul_tf32x3(ds.transpose(1, 2), q, terms=terms) * scale
    return dq, dk, dv


def round_f16(x):
    """fp32 ``x`` rounded to the nearest fp16 (subnormals kept, |x| >= 65520
    to inf) and back to fp32, exactly: what a kernel's fp16 conversion
    keeps."""
    return x.to(torch.float16).float()


def split_f16(x):
    """fp32 ``x`` as the fp16 kernels pass P and dS to the tensor cores:
    hi = x rounded to fp16, lo = the rest rounded to fp16; returns hi + lo
    in fp32 (within 2^-22 |x| while lo is normal, 2^-25 below)."""
    hi = round_f16(x)
    return hi + round_f16(x - hi)


def attention_f16(q, k, v, *, causal: bool = True, window: int = 0,
                  kv_lens: Optional[Sequence[int]] = None,
                  split: bool = True):
    """:func:`attention_ref` as ``csrc/flash_dense.cu`` computes it in fp16:
    q, k, v (bh, s, hd) of fp16 values; S = Q K^T in fp32; P = exp(S - m)
    (m the row's max, P <= 1) passed to P V as :func:`split_f16` (``split``
    False: rounded once to fp16, which the kernels never do); O = P V / l,
    l the fp32 sum of P; the output rounded to fp16 once.  Returns
    (out, o_lo, lse): out fp16, o_lo = round_f16(O - out) (the residual the
    forward writes for the backward) and lse = m + log l fp32.  Rows with
    no live column are 0.  The kernel's running maximum only makes its P
    larger before the rescaling, so rounding against the final maximum
    errs as much or more.  Used by the tests only."""
    bh, s, hd = q.shape
    scores = (q.float() @ k.float().transpose(1, 2)) / math.sqrt(hd)
    mask = _mask(s, q.device, causal=causal, window=window, kv_lens=kv_lens)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    alive = mask.any(dim=-1, keepdim=True)
    o32 = torch.where(alive, ((split_f16(p) if split else round_f16(p))
                              @ v.float()) / l.clamp_min(1e-30), 0.0)
    out = round_f16(o32)
    return (out.to(torch.float16), round_f16(o32 - out).to(torch.float16),
            (m + torch.log(l)).squeeze(-1))


def attention_bwd_f16(q, k, v, do, *, causal: bool = True, window: int = 0,
                      split: bool = True, residual: bool = True):
    """(dq, dk, dv) of the dense function in the model layout, q, do
    (b, s, h, hd), k, v (b, s, kvh, hd) of fp16 values, as
    ``csrc/flash_dense_bwd.cu`` computes them in fp16: the forward of
    :func:`attention_f16` (its fp16 output, o_lo and lse); D = rowsum(dO o
    (O + o_lo)) in fp32 (``residual`` False: from the fp16 O alone); P =
    exp(S - lse) and dS = P o (dP - D) in fp32, each passed to its products
    as :func:`split_f16` (``split`` False: rounded once to fp16); dQ = dS K
    scale, dK = dS^T Q scale and dV = P^T dO summed over the GQA group in
    fp32, then rounded to fp16 once.  Used by the tests only."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)

    def heads(x):
        return x.float().permute(0, 2, 1, 3).repeat_interleave(
            h // x.shape[2], dim=1).reshape(b * h, s, hd)

    qf, kf, vf, dof = (heads(x) for x in (q, k, v, do))
    out, o_lo, lse = attention_f16(qf.half(), kf.half(), vf.half(),
                                   causal=causal, window=window)
    mask = _mask(s, q.device, causal=causal, window=window)
    scores = torch.where(mask, (qf @ kf.transpose(1, 2)) * scale, NEG_INF)
    p = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)
    o = out.float() + (o_lo.float() if residual else 0.0)
    delta = (dof * o).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(1, 2) - delta)
    rnd = split_f16 if split else round_f16
    p, ds = rnd(p), rnd(ds)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(1, 2) @ qf) * scale
    dv = p.transpose(1, 2) @ dof

    def model(x, n):
        return (x.reshape(b, n, h // n, s, hd).sum(2).permute(0, 2, 1, 3)
                .to(torch.float16))

    return model(dq, h), model(dk, kvh), model(dv, kvh)
