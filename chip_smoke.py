#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's kernel paths, prefill and serving on one
NVIDIA GPU.

    python3 chip_smoke.py            # needs one card

It imports only ``repro_torch``, ``torch`` and numpy, builds the CUDA
kernels from ``src/repro_torch/kernels/csrc`` on first use (into
``build/repro_torch``), and prints one JSON line per phase:

  env          the card, torch / CUDA versions, SM count, build seconds and
               each kernel's registers / spills from ``ptxas -v``
  main_path    launch counts set to 0, then the path a user calls at the
               full layer width of qwen3-moe-30b-a3b: ``ops.flash_attention``
               (32 q heads, 4 KV heads, head_dim 128, 8 ragged lanes of
               4096, causal, schedule fac2, sched_p = SM count and 8) and
               the expert FFN through ``ops.grouped_matmul`` (128 experts,
               C 512, wi (128, 2048, 768), wo (128, 768, 2048), fac2); the
               counts are read right after
  small        both kernels against the plain oracles at small, ragged
               shapes (partial blocks, 64-column kv blocks inside a
               128-column tile, windows narrower than a tile, a lane of
               kv_len 0, strided heads, dead tiles)
  flash_sched  the kernel against its plain version at the main path's
               shapes, bit-identity across schedules and sched_p, timing
               (single calls and back to back) and the host planning of a
               call split into its pieces (``plan_split_ms``)
  gmm          the same for the grouped matmul (wi and wo shapes), and
               back-to-back times of the fac2 order, the identity order and
               the identity order with every tile on expert 0
  flash_dense  the dense kernel against its plain version at the prefill's
               shape (qwen3-4b: 1 x 4096, 32 q heads, 8 KV heads,
               head_dim 128, causal), at the full attention shapes of
               stablelm-3b (1 x 4096, 32 / 32 heads, head_dim 80, computed
               at 128, causal) and recurrentgemma-2b (1 x 4096, 10 / 1
               heads, head_dim 256, window 2048), and at small ragged
               shapes (s not a multiple of the tile, MQA, head_dims 64, 80
               and 256, windows from 1 to 2048); per full shape
               (``by_head_dim``) its time (single calls and back to back),
               the plain version's, and ``scaled_dot_product_attention``'s
               with the same mask on the same tensors as a yardstick (the
               port never calls it), and ``digest``: a hash of its outputs
               (head dims 128 and 64) on inputs of a seed of their own,
               equal across builds that compute the same bits
  prefill      launch counts set to 0, then ``models.forward`` of full-width,
               full-depth qwen3-4b (36 layers, random fp32 weights from seed
               0, bf16 compute) on 1 x 4096 tokens from numpy seed 0; the
               counts are read right after (flash_dense: 36).  Wall time,
               tokens/s, a device profile of a second run, and at 2 layers
               ``forward`` against ``decode_step`` fed the same 2560 tokens
               one by one
  serve        ``DecodeEngine`` through ``launch.serve``'s code path on
               full-width qwen3-4b: 8 requests drawn as the launcher draws
               them, 4 slots, max_len 256, fac2; again with the int8 KV
               cache; a device profile of a short run
  moe_prefill  launch counts set to 0, then ``models.forward`` of
               full-width qwen3-moe-30b-a3b cut to 8 of 48 layers (random
               fp32 weights from seed 0, bf16 compute, dispatch "ragged")
               on 1 x 4096 tokens; the counts are read right after (gmm:
               3 a layer, flash_dense: 1 a layer).  Wall time, tokens/s, a
               device profile, a second run bit-identical to the first,
               the share of (token, k) slots dropped at capacity factor
               1.25; one layer's ragged FFN against the same call with the
               plain grouped matmul in place of ``grouped_matmul``; at
               capacity factor E / top_k (16: no expert can overflow) every
               layer's FFN under the ragged and the dense dispatch on the
               input that layer had in the run (routed alike by
               construction), then the ragged logits of 2 layers against
               the dense dispatch's; gmm timed alone at the model path's
               shapes
  moe_serve    ``DecodeEngine`` through ``launch.serve``'s code path on the
               same model: 8 requests, 4 slots, max_len 256, fac2, bf16 KV;
               a device profile of a short run
  recurrent    xlstm-1.3b and recurrentgemma-2b at full width and depth:
               a 4096-token prefill (launch counts from 0; recurrentgemma's
               8 ``local_attn`` layers launch flash_dense at head_dim 256,
               window 2048, once each) and a device profile of it where it
               launches flash_dense.  Then a device
               profile of a 512-token prefill (below flash_threshold, the
               einsum attention of every arch), ``forward`` against
               ``decode_step`` on one block-pattern period (8 and 3 layers)
               fed the same tokens, and ``DecodeEngine`` with 4 requests on
               2 slots, so that lanes are reset and reused
  prefill_80   launch counts set to 0, then ``models.forward`` of
               full-width, full-depth stablelm-3b (32 layers, head_dim 80,
               random fp32 weights from seed 0, ~11 GB, bf16 compute) on
               1 x 4096 tokens; the counts are read right after
               (flash_dense: 32).  Wall time, tokens/s, a device profile
  campaign     the port's campaign engine (``core.graph_sim``) on the card
               at the paper's Table 1 size: 352.nab (N 44,794) on
               miniHPC-Broadwell (p 20) and miniHPC-KNL (p 64), the
               campaign's 9 adaptive techniques at every Table 1 chunk
               parameter, 5 repetitions (folded into one lane each: the
               simulator is deterministic), 3 of 352.nab's 1,002
               time-steps, held against the host ``batch_sim`` (rtol 1e-9
               at p >= 8, BOLD's log-ulp tolerance the same); lanes,
               rounds, host syncs and wall time, and a device profile of
               one technique's lane group; then
               ``auto_simulate(engine="graph")`` on the card against
               ``engine="batch"`` (the same arms) and
               ``plan_schedule(backend="graph")`` on the card against the
               host plan for every plannable technique at p 20 and 64
  kernels      the summary line, one entry per kernel; ``launches`` sums
               the counted runs of every path that launches the kernel
               (``launches_by_path``); flash_dense's entry carries
               ``by_head_dim``

then the card's name and power limit as ``nvidia-smi`` prints them, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; it also exits non-zero, printing no result, when no
CUDA device is present or ``src/repro_torch`` is missing beside it.

    python3 chip_smoke.py --dense-digest [SRC]
    python3 chip_smoke.py --dense-times [SRC]

print only that digest, or only ``flash_dense``'s single-call and
back-to-back times at the prefill's shape (head_dim 128, causal) and at
head_dim 64 with a window of 200, for the package under ``SRC``
(default: this checkout's ``src``), so that another tree's
``flash_dense`` can be held against this one bit for bit, and timed
against it in turns (parent, change, change, parent) in one call.

Tolerance of the 2-layer ``forward`` / ``decode_step`` comparison (bf16
compute), also held by the recurrent ``forward`` / ``decode_step``
comparisons and by the 2-layer MoE dispatch comparison on the tokens that
both dispatches route to the same experts in every layer, which must be
at least 90% of them (the argmax bound holds for all tokens there): max
|logit difference| <= 0.25 and the same argmax at >= 80% of the positions.
The layer-by-layer MoE dispatch comparison holds every token's FFN output
to the same 0.25.  Both paths keep the residual stream in
bf16 (a step of 2^-8 to 2^-7 near 1), and they differ in where they round:
the prefill's attention is the dense kernel (fp32 scores and
probabilities, one rounding of the output to bf16), the decode's rounds
scores and probabilities to bf16 and multiplies a one-row GEMV where the
prefill runs a GEMM.  The logits of random weights have a spread of about
1, so a difference of a few bf16 steps in the hidden state moves a logit by
about 0.01-0.05 and flips the argmax where the two largest logits lie
closer than that.  The recurrent forms differ more: the chunkwise mLSTM
rounds its scores to bf16 where the step form keeps an fp32 state, and the
states carry a difference on from step to step.

The plain versions run with TF32 off (``torch.backends.cuda.matmul.
allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` False), in fp32.
Tolerance for a bf16 kernel output against the plain version:
|kernel - plain| <= 2^-7 + 2^-7 * |plain|, i.e. about two bf16 rounding
steps: the kernels sum in another order (and split P into two bf16 terms)
before the final rounding to bf16.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 rate
ATOL = RTOL = 2.0 ** -7
REPS = 20                    # timed calls per kernel measurement

# main-path widths: qwen3-moe-30b-a3b (src/repro/configs/qwen3_moe_30b_a3b.py)
B, S, H, KVH, HD = 8, 4096, 32, 4, 128
# this slice: qwen3-4b (src/repro/configs/qwen3_4b.py) at full width
ARCH, PREFILL_S, PARITY_S, PARITY_LAYERS = "qwen3-4b", 4096, 2560, 2
SERVE_REQUESTS, SERVE_SLOTS, SERVE_MAX_LEN = 8, 4, 256
PARITY_MAX_DIFF, PARITY_ARGMAX = 0.25, 0.80
E, C, D_MODEL, D_FF, BLOCK_ROWS = 128, 512, 2048, 768, 128
# this slice: the MoE and recurrent families
MOE_ARCH, MOE_LAYERS, MOE_PARITY_LAYERS = "qwen3-moe-30b-a3b", 8, 2
MOE_ROUTED_ALIKE = 0.90
RECURRENT_ARCHS = ("xlstm-1.3b", "recurrentgemma-2b")
RECURRENT_PARITY_S, RECURRENT_PROFILE_S = 640, 512
RECURRENT_REQUESTS, RECURRENT_SLOTS = 4, 2
# this slice: flash_dense at head dim 80 (src/repro/configs/stablelm_3b.py)
DENSE80_ARCH = "stablelm-3b"
# the campaign phase: time-steps of each Table 1 config (of 352.nab's 1,002)
CAMPAIGN_TIMESTEPS = 3
IDENTITY_SCHEDULES = ("static", "ss", "gss", "fac2", "awf_b", "ws_rr",
                      "dls_steal")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check_close(name, got, want):
    """Max abs error of a bf16 kernel output; raises outside
    |got - want| <= ATOL + RTOL |want|."""
    diff = (got.float() - want.float()).abs()
    bad = diff > ATOL + RTOL * want.float().abs()
    err = float(diff.max())
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} elements outside tolerance, "
        f"max abs err {err}")
    return err


def cuda_ms(fn, n):
    """Median device time of ``fn`` over ``n`` calls after one warm-up, in
    ms (CUDA events)."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_b2b(fn, n):
    """ms per call of ``fn`` launched ``n`` times back to back between two
    CUDA events, after one warm-up; the median of 3 rounds.  A call's host
    work overlaps the previous call's kernel, so where the kernel is the
    longer this is near its own time (``cuda_ms`` also counts the host work
    before the launch)."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        rounds.append(a.elapsed_time(b) / n)
    return float(np.median(rounds))


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the bf16 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def device_profile(fn, top=8, watch=()):
    """Run ``fn`` under ``torch.profiler``: wall ms, the summed device time
    of the kernels, the device's idle share of the wall time, the ``top``
    kernels by device time and, for each substring in ``watch``, the device
    ms and count of the kernels whose name holds it (the profiler's own
    overhead is in the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((us / 1e3, ev.count, ev.key[:90]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    out = dict(wall_ms=wall_ms, device_ms=busy_ms,
               idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
               launches=sum(k[1] for k in kernels),
               top=[{"kernel": k[2], "ms": k[0], "count": k[1]}
                    for k in kernels[:top]])
    for sub in watch:
        hit = [k for k in kernels if sub in k[2]]
        out[sub] = {"ms": sum(k[0] for k in hit),
                    "count": sum(k[1] for k in hit)}
    return out


def first_layers(cfg, params, n):
    """``cfg`` cut to its first ``n`` layers, a whole number of
    block-pattern periods, and those layers' parameters (views)."""
    import dataclasses

    import torch
    period = len(cfg.block_pattern)
    assert n % period == 0 and n <= cfg.num_layers, (n, period)
    g = n // period

    def cut(v):
        return v[:g] if torch.is_tensor(v) else {k: cut(x)
                                                  for k, x in v.items()}

    return (dataclasses.replace(cfg, num_layers=n),
            dict(params, groups=tuple(cut(grp) for grp in params["groups"]),
                 remainder=()))


def plain_grouped_matmul(xe, w, *, block_rows, **_):
    """``grouped_matmul``'s identity-order product on the plain version,
    to stand in for it in the model's ragged dispatch."""
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    e, r, d = xe.shape
    tiles = r // block_rows
    te = torch.arange(e * tiles, device=xe.device) // tiles
    return gm.grouped_matmul_tiles_plain(
        xe.reshape(e * tiles, block_rows, d), w, te).reshape(e, r, -1)


def logits_agree(name, got, want):
    """(max |difference|, argmax agreement) of two logit tensors; raises
    outside PARITY_MAX_DIFF and PARITY_ARGMAX."""
    diff = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    assert diff <= PARITY_MAX_DIFF and agree >= PARITY_ARGMAX, (
        name, diff, agree)
    return diff, agree


def decode_parity(dev, cfg, params, tokens):
    """``forward`` against ``decode_step`` fed the same tokens one by one:
    (max |difference|, argmax agreement, seconds of the decode loop, the
    largest |logit| of ``forward``)."""
    import torch
    from repro_torch.models import decode_step, forward, init_decode_state
    s = tokens.shape[1]
    full, _ = forward(params, cfg, tokens)
    state = init_decode_state(cfg, 1, max_len=s, device=dev)
    steps = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(s):
            step, state = decode_step(params, cfg, state, tokens[:, i:i + 1])
            steps.append(step[0, 0])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return (*logits_agree(cfg.name, torch.stack(steps), full[0]), decode_s,
            float(full.abs().max()))


def host_ms(fn, n=REPS):
    """Median host time of ``fn`` over ``n`` single calls after one
    warm-up, in ms (no device synchronisation)."""
    import numpy as np
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def plan_split_ms(fa, lane_lens, p, dev):
    """The host work of one ``flash_sched`` call at the main path's shape
    (fac2, ``p`` workers), piece by piece: the per-group kv ranges and
    costs, the DLS plan, the descriptors and CTA bounds, and the pinned
    upload of the table (enqueue only)."""
    from repro_torch.core.torch_sched import plan_tiles_for_kernel
    nq = S // 512
    kw = dict(causal=True, window=0, kv_lens=lane_lens)
    lo, hi, costs, lens = fa._kv_ranges(B * H, S, 512, 512, **kw)
    plan = plan_tiles_for_kernel(costs, p=p, technique="fac2")
    desc = fa._descriptors(plan.order, lo, hi, lens, nq)
    bounds = fa.descriptor_bounds(desc, plan)
    return {
        "costs": host_ms(lambda: fa._kv_ranges(B * H, S, 512, 512, **kw)),
        "plan": host_ms(lambda: plan_tiles_for_kernel(costs, p=p,
                                                      technique="fac2")),
        "descriptors": host_ms(lambda: fa.descriptor_bounds(
            fa._descriptors(plan.order, lo, hi, lens, nq), plan)),
        "upload": host_ms(lambda: fa._upload_table(desc, bounds, dev))}


def sched_tiles(desc, bounds, block_q, block_k):
    """(total, most on one CTA): the live 128 x 128 tiles of a causal
    ``flash_sched`` launch without a window, counted from its descriptors
    as ``flash_sched.cu``'s Walk counts them; the CTA with the most sets
    the kernel's time."""
    import numpy as np
    _, qi, kj, first, last, lim = (np.asarray(a, np.int64) for a in desc)
    g0, g1 = np.flatnonzero(first), np.flatnonzero(last)
    qb0 = qi[g0] * block_q
    qb1 = np.minimum(qb0 + block_q, S)
    c_lo = kj[g0] * block_k
    c_end = np.minimum(np.minimum((kj[g1] + 1) * block_k, S), lim[g0])
    per_group = np.zeros(g0.size, np.int64)
    for row0 in range(0, block_q, 128):
        row0 = qb0 + row0
        hi = np.minimum(c_end, np.minimum(row0 + 128, qb1))
        n = (hi - 1 - c_lo) // 128 + 1
        per_group += np.where((row0 < qb1) & (hi > c_lo), n, 0)
    cta = np.searchsorted(np.asarray(bounds), g0, side="right") - 1
    per_cta = np.bincount(cta, per_group, minlength=len(bounds) - 1)
    return int(per_group.sum()), int(per_cta.max())


def dense_digest(dev):
    """sha256 (16 hex digits) of ``flash_dense``'s bf16 outputs at the
    prefill's shape (causal) and at a small windowed head_dim-64 shape, on
    inputs from a generator of their own (seed 1234), so that two builds
    of the kernel can be held bit for bit against each other."""
    import hashlib

    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(1234)
    h = hashlib.sha256()
    for b, s, h_, kvh, hd, win in ((1, PREFILL_S, 32, 8, 128, 0),
                                   (1, 1000, 4, 1, 64, 200)):
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h_, kvh, kvh))
        out = fa._flash_dense_cuda(q, k, v, causal=True, window=win)
        h.update(out.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dense_kernel_ms(q, k, v, window):
    """``flash_dense``'s kernel alone, causal: (ms of single calls, ms back
    to back)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    def kernel():
        return fa._flash_dense_cuda(q, k, v, causal=True, window=window)

    return cuda_ms(kernel, REPS), cuda_ms_b2b(kernel, REPS)


def dense_full_shape(dev, randn, plain, b, s, h, kvh, hd, window):
    """``flash_dense`` at one full (b, s, h, kvh, hd, window) shape, causal:
    the kernel against its plain version, its times (single calls and back
    to back), the plain version's, ``scaled_dot_product_attention``'s with
    the same mask (a yardstick: the port never calls it) and the bound from
    the live (row, column) pairs.  Returns (fields, the kernel's output)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q, k, v = randn(b, s, h, hd), randn(b, s, kvh, hd), randn(b, s, kvh, hd)
    out = flash_attention(q, k, v, causal=True, window=window)
    err = check_close(f"flash_dense hd {hd}", out, plain(q, k, v, True,
                                                          window))
    ms, ms_b2b = dense_kernel_ms(q, k, v, window)
    call_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                              window=window), REPS)
    plain_ms = cuda_ms(lambda: plain(q, k, v, True, window), 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.permute(0, 2, 1, 3)
    kt, vt = (x.permute(0, 2, 1, 3).repeat_interleave(h // kvh, dim=1)
              for x in (k, v))
    if window > 0:
        i = torch.arange(s, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

        def run_sdpa():
            return sdpa(qt, kt, vt, attn_mask=mask)
    else:
        def run_sdpa():
            return sdpa(qt, kt, vt, is_causal=True)
    library_ms = cuda_ms(run_sdpa, REPS)
    sdpa_err = float((run_sdpa().permute(0, 2, 1, 3).float()
                      - out.float()).abs().max())
    # live (row, col) pairs: row r sees min(r + 1, window) columns
    rows = torch.arange(1, s + 1, dtype=torch.float64)
    pairs = int((torch.minimum(rows, torch.tensor(float(window)))
                 if window > 0 else rows).sum())
    flops = 4 * hd * b * h * pairs
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(shape=[b, s, h, kvh, hd], window=window, max_abs_err=err,
                ms=ms, ms_b2b=ms_b2b, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                sdpa_max_abs_diff=sdpa_err, flops=flops, bytes=nbytes), out


def dense_times(dev):
    """``flash_dense``'s ms and ms_b2b at the qwen3-4b prefill's shape and
    at head_dim 64, window 200, on inputs of a seed of their own."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for key, (b, s, h, kvh, hd, win) in (
            ("hd128", (1, PREFILL_S, 32, 8, 128, 0)),
            ("hd64_w200", (1, PREFILL_S, 32, 8, 64, 200))):
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h, kvh, kvh))
        ms, ms_b2b = dense_kernel_ms(q, k, v, win)
        out[key] = {"ms": ms, "ms_b2b": ms_b2b}
    return out


def phase_flash_dense(dev, randn):
    """The dense kernel against its plain version at the prefill's shape,
    at the full attention shapes of stablelm-3b (head dim 80, computed at
    128) and recurrentgemma-2b (head dim 256, window 2048) and at small
    ragged ones; times and bounds of each full shape.  Returns the fields
    of its ``kernels`` entry (launches come from the prefills)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention

    def plain(q, k, v, causal=True, window=0):
        b, s, h, hd = q.shape
        out = fa.flash_attention_dense_plain(*fa.broadcast_flatten(q, k, v),
                                             causal=causal, window=window)
        return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)

    small = {}
    for b, s, h, kvh, hd, win, causal in ((2, 300, 4, 2, 128, 0, True),
                                          (1, 200, 4, 1, 64, 32, True),
                                          (2, 333, 8, 2, 128, 200, True),
                                          (1, 1000, 4, 1, 64, 200, True),
                                          (1, 96, 2, 2, 64, 0, False),
                                          # the padded head dims
                                          (1, 300, 4, 2, 80, 0, True),
                                          (2, 333, 4, 1, 80, 100, True),
                                          (1, 200, 2, 2, 80, 0, False),
                                          (1, 300, 4, 2, 256, 0, True),
                                          (2, 333, 5, 1, 256, 100, True),
                                          (1, 2100, 10, 1, 256, 2048, True),
                                          (1, 129, 2, 1, 256, 1, True),
                                          (1, 200, 2, 2, 256, 0, False)):
        qs, ks, vs = randn(b, s, h, hd), randn(b, s, kvh, hd), \
            randn(b, s, kvh, hd)
        got = flash_attention(qs, ks, vs, causal=causal, window=win)
        key = f"s{s}_h{h}_kv{kvh}_hd{hd}_w{win}" + ("" if causal else "_full")
        small[key] = check_close("flash_dense small", got,
                                 plain(qs, ks, vs, causal, win))

    by_head_dim = {}
    for arch, window in ((ARCH, 0), ("stablelm-3b", 0),
                         ("recurrentgemma-2b", 2048)):
        cfg = get_arch(arch)
        assert cfg.window in (0, window), (arch, cfg.window)
        fields, _ = dense_full_shape(
            dev, randn, plain, 1, PREFILL_S, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, window)
        by_head_dim[str(cfg.resolved_head_dim)] = dict(arch=arch, **fields)
    main = by_head_dim["128"]
    fields = {k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
    emit("flash_dense", shape=main["shape"], causal=True,
         digest=dense_digest(dev), small_max_abs_err=small,
         ms_b2b=main["ms_b2b"], call_ms=main["call_ms"],
         sdpa_max_abs_diff=main["sdpa_max_abs_diff"], flops=main["flops"],
         bytes=main["bytes"], by_head_dim=by_head_dim, **fields)
    fields["max_abs_err"] = max(r["max_abs_err"] for r in by_head_dim.values())
    fields["by_head_dim"] = {
        hd: {k: r[k] for k in ("arch", "shape", "window", "max_abs_err", "ms",
                               "ms_b2b", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")}
        for hd, r in by_head_dim.items()}
    return fields


def phase_prefill(dev, cfg, params, phase="prefill", parity=True):
    """``forward`` of the full model with the counts from 0 (the slice's
    main path), then timing, a device profile and (``parity``) the 2-layer
    comparison of ``forward`` with ``decode_step``.  Returns the launch
    counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import forward

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_S))).to(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, _ = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    assert launches["flash_dense"] == cfg.num_layers, launches
    assert tuple(logits.shape) == (1, PREFILL_S, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    del logits

    def run():
        forward(params, cfg, tokens)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    prof = device_profile(run, watch=("flash_dense",))
    fields = dict(arch=cfg.name, layers=cfg.num_layers, tokens=PREFILL_S,
                  head_dim=cfg.resolved_head_dim, launches=launches,
                  first_s=first_s, warm_s=warm_s,
                  tokens_per_s=PREFILL_S / warm_s, profile=prof)
    if not parity:
        emit(phase, cut="none: full width and depth; random fp32 weights "
             "from seed 0", **fields)
        return launches

    # forward against decode_step on the same tokens, 2 layers
    cfg2, params2 = first_layers(cfg, params, PARITY_LAYERS)
    tok2 = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, PARITY_S))).to(dev)
    before = _build.KERNELS["flash_dense"].launches
    max_diff, agree, decode_s, logit_abs_max = decode_parity(dev, cfg2,
                                                             params2, tok2)
    assert _build.KERNELS["flash_dense"].launches == before + PARITY_LAYERS
    emit(phase, **fields,
         parity={"layers": PARITY_LAYERS, "s": PARITY_S,
                 "max_abs_diff": max_diff, "argmax_agreement": agree,
                 "tolerance": [PARITY_MAX_DIFF, PARITY_ARGMAX],
                 "logit_abs_max": logit_abs_max, "decode_s": decode_s})
    return launches


def phase_serve(dev, cfg, params):
    """DecodeEngine through ``launch.serve``'s code path, bf16 and int8 KV
    caches, then a device profile of a short run."""
    import dataclasses

    import torch

    rows = {}
    for name, c in (("bf16", cfg),
                    ("kv8", dataclasses.replace(cfg, kv_cache_dtype="int8"))):
        rows[name], eng = serve_rows(dev, c, params, SERVE_REQUESTS,
                                     SERVE_SLOTS, SERVE_MAX_LEN)
        assert len(eng.kernel_records) == eng.plan_calls
        rows[name].update(plan_calls=eng.plan_calls,
                          plan_time_s=eng.plan_time_s,
                          plan_cache_hits=eng.plan_cache_hits)
        del eng
        torch.cuda.empty_cache()
    prof = device_profile(lambda: serve_rows(dev, cfg, params, 4,
                                             SERVE_SLOTS, 64, seed=1))
    emit("serve", arch=cfg.name, requests=SERVE_REQUESTS, slots=SERVE_SLOTS,
         max_len=SERVE_MAX_LEN, technique="fac2", profile_4_requests=prof,
         **rows)


def serve_rows(dev, cfg, params, n, slots, max_len, seed=0):
    """``n`` requests drawn as the launcher draws them through
    ``launch.serve``'s ``run_engine`` on ``slots`` slots; raises unless all
    complete with the tokens asked for.  Returns (the engine's numbers, the
    engine)."""
    import numpy as np
    from repro_torch.launch.serve import make_requests, run_engine
    requests = make_requests(n, max_len, seed)
    eng, stats = run_engine(cfg, params, requests, slots=slots,
                            max_len=max_len, technique="fac2", device=dev)
    assert stats.completed == n, (cfg.name, stats)
    for r in requests:
        out = eng.output(r.rid)
        assert len(out) == min(r.max_new_tokens, max_len // 2), r.rid
        assert all(0 <= t < cfg.padded_vocab for t in out), (cfg.name, r.rid)
    return dict(completed=f"{stats.completed}/{n}", steps=stats.steps,
                tokens=stats.tokens, tok_per_s=stats.tok_per_s,
                wall_s=stats.wall_s,
                step_ms_median=float(np.median(stats.step_ms)),
                step_ms_p90=float(np.percentile(stats.step_ms, 90)),
                sample_output=eng.output(0)[:8]), eng


def gmm_model_shapes(dev, cfg, n_sm, randn):
    """``gmm`` alone at the MoE prefill's expert shapes (the identity tile
    order with one CTA per SM, as ``moe_ragged`` calls it): single-call and
    back-to-back ms of wi + wg + wo, the plain version's and ``torch.bmm``'s
    ms, and the bound of the three calls."""
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    from repro_torch.models.moe import _capacity
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    rows = -(-_capacity(cfg, PREFILL_S) // BLOCK_ROWS) * BLOCK_ROWS
    x, h = randn(e, rows, d), randn(e, rows, f)
    w_in = randn(e, d, f, scale=d ** -0.5)
    w_out = randn(e, f, d, scale=f ** -0.5)
    tiles = e * rows // BLOCK_ROWS
    te = torch.arange(tiles, device=dev) // (rows // BLOCK_ROWS)
    calls = ((x, w_in), (x, w_in), (h, w_out))      # wi, wg, wo
    out = {"ms": 0.0, "ms_b2b": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "flops": 0, "bytes": 0}
    for xi, w in calls:
        def run(xi=xi, w=w):
            return grouped_matmul(xi, w, block_rows=BLOCK_ROWS, sched_p=n_sm)
        out["ms"] += cuda_ms(run, REPS)
        out["ms_b2b"] += cuda_ms_b2b(run, REPS)
        xt = xi.reshape(tiles, BLOCK_ROWS, xi.shape[2])
        out["plain_ms"] += cuda_ms(
            lambda xt=xt, w=w: gm.grouped_matmul_tiles_plain(xt, w, te), 3)
        out["library_ms"] += cuda_ms(lambda xi=xi, w=w: torch.bmm(xi, w),
                                     REPS)
        out["flops"] += 2 * e * rows * xi.shape[2] * w.shape[2]
        out["bytes"] += 2 * (xi.numel() + w.numel() + e * rows * w.shape[2])
    out["bound_ms"], out["bound_by"] = bound(out["flops"], out["bytes"])
    out["shapes"] = {"x": [e, rows, d], "wi_wg": [e, d, f], "wo": [e, f, d]}
    return out


def phase_moe_prefill(dev, n_sm, randn):
    """``forward`` of qwen3-moe-30b-a3b (8 layers, ragged dispatch) with the
    counts from 0, then timing, a profile, bit-identity, the dropped-slot
    share, the kernel-against-plain check of one layer's FFN, the 2-layer
    dense-dispatch comparison and gmm at the model's shapes.  Returns
    (cfg, params, launches, gmm's model-path fields for the kernels line)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import decoder, forward, init_decoder
    from repro_torch.models import moe as tmoe

    base = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(
        base, num_layers=MOE_LAYERS,
        moe=dataclasses.replace(base.moe, dispatch="ragged"))
    params, _ = init_decoder(0, cfg, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_S))).to(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, aux = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    assert launches["gmm"] == 3 * cfg.num_layers, launches
    assert launches["flash_dense"] == cfg.num_layers, launches
    assert tuple(logits.shape) == (1, PREFILL_S, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()), "MoE logits not finite"

    def run():
        forward(params, cfg, tokens)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    prof = device_profile(run, top=10, watch=("gmm", "flash_dense"))

    # a second run, bit for bit, recording each layer's FFN input and loads
    cap = tmoe._capacity(cfg, PREFILL_S)
    taps = []
    real_moe = decoder.moe

    def moe_tap(p, c, x):
        out = real_moe(p, c, x)
        taps.append((p, x, out[2]))
        return out

    decoder.moe = moe_tap
    try:
        again, _ = forward(params, cfg, tokens)
    finally:
        decoder.moe = real_moe
    assert torch.equal(again, logits), "two MoE prefills differ"
    del again, logits
    load = torch.stack([t[2] for t in taps])        # (layers, E)
    # one sequence is one token group, so an expert drops load - cap slots
    dropped = float(torch.clamp_min(load - cap, 0).sum()
                    / (cfg.num_layers * PREFILL_S * cfg.moe.top_k))

    # one layer's ragged FFN: gmm against the plain grouped matmul
    ffn0 = {k: v[0] for k, v in params["groups"][0]["ffn"].items()}
    x = randn(1, PREFILL_S, cfg.d_model)
    y = tmoe.moe_ragged(ffn0, cfg, x)[0]
    real_gm = tmoe.grouped_matmul
    tmoe.grouped_matmul = plain_grouped_matmul
    try:
        want = tmoe.moe_ragged(ffn0, cfg, x)[0]
    finally:
        tmoe.grouped_matmul = real_gm
    ffn_err = check_close("moe_ragged", y, want)
    del y, want, x

    # every layer's FFN under both dispatches on the input it had in the
    # run above, at capacity factor E / top_k: the capacity is then the
    # token count, so no expert can overflow, and the router sees one input,
    # so both dispatches route every token alike (equal loads)
    parity_cf = cfg.moe.num_experts / cfg.moe.top_k
    cfg_cf = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=parity_cf))
    assert tmoe._capacity(cfg_cf, PREFILL_S) >= PREFILL_S
    layer_diff, layer_abs = [], []
    for p, x, _ in taps:
        yr, _, load_r = tmoe.moe_ragged(p, cfg_cf, x)
        yd, _, load_d = tmoe.moe_dense(p, cfg_cf, x)
        assert torch.equal(load_r, load_d), "the dispatches routed apart"
        layer_diff.append(float((yr - yd).abs().max()))
        layer_abs.append(float(yd.abs().max()))
    del taps, yr, yd
    assert max(layer_diff) <= PARITY_MAX_DIFF, layer_diff

    # 2 layers end to end, ragged against dense at the same capacity
    # factor (at 8 the random router sent 2219 of 4096 tokens to one
    # expert of the second layer, over its capacity of 2048, and the ragged
    # dispatch dropped them).  The first layer's router sees the same input
    # under both dispatches; the second's sees hidden states that differ by
    # bf16 rounding, and where a token's 8th and 9th experts are that close
    # the two runs pick different experts for it, which moves its logits by
    # far more than a rounding step.  So the difference bound holds the
    # tokens routed alike in every layer, which must be at least
    # MOE_ROUTED_ALIKE of them; the argmax bound holds all tokens.
    cfg2, params2 = first_layers(cfg_cf, params, MOE_PARITY_LAYERS)
    logits2, routes, loads2 = {}, {}, {}
    real_route = tmoe._route

    def route_tap(*args):
        out = real_route(*args)
        routes[dispatch].append(torch.sort(out[0][0], dim=-1).values)
        loads2[dispatch].append(int(out[3].max()))
        return out

    tmoe._route = route_tap
    try:
        for dispatch in ("ragged", "dense"):
            routes[dispatch], loads2[dispatch] = [], []
            c = dataclasses.replace(cfg2, moe=dataclasses.replace(
                cfg2.moe, dispatch=dispatch))
            logits2[dispatch] = forward(params2, c, tokens)[0][0]
    finally:
        tmoe._route = real_route
    same = [(a == b).all(-1) for a, b in zip(routes["ragged"],
                                             routes["dense"])]
    assert bool(same[0].all()), "layer 1 routed differently"
    alike = torch.stack(same).all(0)                         # (s,)
    alike_share = float(alike.float().mean())
    assert alike_share >= MOE_ROUTED_ALIKE, alike_share
    diff_all = float((logits2["ragged"] - logits2["dense"]).abs().max())
    diff, agree = logits_agree("ragged vs dense, tokens routed alike",
                               logits2["ragged"][alike],
                               logits2["dense"][alike])
    agree_all = float((logits2["ragged"].argmax(-1)
                       == logits2["dense"].argmax(-1)).float().mean())
    assert agree_all >= PARITY_ARGMAX, agree_all
    logit_abs_max = float(logits2["dense"].abs().max())
    del logits2, params2
    gmm = gmm_model_shapes(dev, cfg, n_sm, randn)
    emit("moe_prefill", arch=cfg.name, layers=cfg.num_layers,
         cut=f"{cfg.num_layers} of {base.num_layers} layers; random fp32 "
             "weights from seed 0",
         dispatch="ragged", tokens=PREFILL_S, launches=launches,
         first_s=first_s, warm_s=warm_s, tokens_per_s=PREFILL_S / warm_s,
         aux=float(aux), profile=prof, bit_identical=True,
         capacity=cap, dropped_share_cf1_25=dropped,
         ffn_plain_max_abs_err=ffn_err,
         load_max_per_layer=load.max(-1).values.tolist(),
         dispatch_by_layer={"capacity_factor": parity_cf,
                            "max_abs_diff": layer_diff,
                            "ffn_abs_max": layer_abs,
                            "tolerance": PARITY_MAX_DIFF},
         dispatch_parity={"layers": MOE_PARITY_LAYERS,
                          "capacity_factor": parity_cf,
                          "load_max_per_layer": loads2,
                          "tokens_routed_alike": int(alike.sum()),
                          "routed_alike_floor": MOE_ROUTED_ALIKE,
                          "max_abs_diff": diff, "argmax_agreement": agree,
                          "max_abs_diff_all": diff_all,
                          "argmax_agreement_all": agree_all,
                          "logit_abs_max": logit_abs_max,
                          "tolerance": [PARITY_MAX_DIFF, PARITY_ARGMAX]},
         gmm_model_shapes=gmm)
    return cfg, params, launches, gmm


def phase_moe_serve(dev, cfg, params):
    """The MoE model in DecodeEngine: 8 requests on 4 slots; the counts
    from 0 around the run; then a device profile of a short run."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    row, _ = serve_rows(dev, cfg, params, SERVE_REQUESTS, SERVE_SLOTS,
                        SERVE_MAX_LEN)
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    assert launches["gmm"] > 0, launches
    prof = device_profile(lambda: serve_rows(dev, cfg, params, 4, SERVE_SLOTS,
                                             64, seed=1),
                          watch=("gmm",))
    emit("moe_serve", arch=cfg.name, layers=cfg.num_layers, dispatch="ragged",
         requests=SERVE_REQUESTS, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
         technique="fac2", kv="bf16", launches=launches,
         profile_4_requests=prof, **row)
    return launches


def phase_recurrent(dev, arch):
    """A full-width, full-depth recurrent model: 4096-token prefill with the
    counts from 0 (recurrentgemma-2b's local attention runs ``flash_dense``
    at head dim 256, once per ``local_attn`` layer), a profile of the warm
    prefill where it launches ``flash_dense`` and of a short prefill,
    forward against decode_step on one block-pattern period, and serving
    with lane reuse.  Returns the prefill's launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import forward, init_decoder

    cfg = get_arch(arch)
    params, _ = init_decoder(0, cfg, device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, PREFILL_S))).to(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, _ = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    n_attn = sum(kind in ("attn", "local_attn")
                 for kind in cfg.pattern_layers)
    assert launches["flash_dense"] == n_attn, (arch, launches, n_attn)
    assert tuple(logits.shape) == (1, PREFILL_S, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()), f"{arch} logits not finite"
    del logits
    t0 = time.perf_counter()
    forward(params, cfg, tokens)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    prefill = {"first_s": first_s, "warm_s": warm_s,
               "tokens_per_s": PREFILL_S / warm_s}
    if n_attn:
        prefill["profile"] = device_profile(
            lambda: forward(params, cfg, tokens), top=6,
            watch=("flash_dense",))
    # below flash_threshold every arch's attention is the einsum branch
    short = tokens[:, :RECURRENT_PROFILE_S]
    prof = device_profile(lambda: forward(params, cfg, short), top=6)

    period = len(cfg.block_pattern)
    cfg_p, params_p = first_layers(cfg, params, period)
    ptok = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, RECURRENT_PARITY_S))).to(dev)
    diff, agree, decode_s, logit_abs_max = decode_parity(dev, cfg_p,
                                                         params_p, ptok)
    del params_p
    row, _ = serve_rows(dev, cfg, params, RECURRENT_REQUESTS,
                        RECURRENT_SLOTS, SERVE_MAX_LEN)
    emit("recurrent", arch=arch, layers=cfg.num_layers,
         pattern=list(cfg.block_pattern), tokens=PREFILL_S,
         launches=launches, prefill=prefill,
         profile={"tokens": RECURRENT_PROFILE_S, **prof},
         parity={"layers": period, "s": RECURRENT_PARITY_S,
                 "max_abs_diff": diff, "argmax_agreement": agree,
                 "tolerance": [PARITY_MAX_DIFF, PARITY_ARGMAX],
                 "logit_abs_max": logit_abs_max, "decode_s": decode_s},
         serve={"requests": RECURRENT_REQUESTS, "slots": RECURRENT_SLOTS,
                "max_len": SERVE_MAX_LEN, "technique": "fac2", **row})
    del params
    torch.cuda.empty_cache()
    return launches


def _records_agree(name, got, want, rtol):
    """A graph-band result against the host batch engine's: equal chunk
    counts, finish times and t_par within ``rtol`` (0: bit for bit)."""
    import numpy as np
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        rg, rw = g.record, w.record
        assert g.engine_used == "graph", (name, g.engine_used)
        assert rg.n_chunks == rw.n_chunks, (name, rg.n_chunks, rw.n_chunks)
        if rtol == 0:
            assert rg.t_par == rw.t_par, name
            assert np.array_equal(rg.thread_finish, rw.thread_finish), name
        else:
            np.testing.assert_allclose(rg.thread_finish, rw.thread_finish,
                                       rtol=rtol, err_msg=name)
            np.testing.assert_allclose(rg.t_par, rw.t_par, rtol=rtol,
                                       err_msg=name)


def phase_campaign(dev):
    """The port's campaign engine (``graph_sim``) on the card at the paper's
    Table 1 size (``configs/paper_campaign.py``): 352.nab (N = 44,794) on
    miniHPC-Broadwell (p = 20) and miniHPC-KNL (p = 64), the campaign's
    adaptive techniques at every Table 1 chunk parameter, 5 repetitions,
    ``CAMPAIGN_TIMESTEPS`` of Table 1's 1,002 time-steps (so every
    technique's adaptive state carries from instance to instance on the
    card), held against the host batch engine: bit for bit below p = 8
    (not reached here), rtol 1e-9 above, BOLD included (its documented
    log-ulp tolerance is the same rtol).  The simulator is deterministic,
    so both engines fold the repetitions of a config into one lane.  Then
    ``auto_simulate(engine="graph")`` on the card against
    ``engine="batch"`` (the same arms), and ``plan_schedule(backend="graph")``
    on the card against the host plan for every plannable technique."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_campaign import CAMPAIGN
    from repro_torch.core import (REGISTRY, AutoSelector, BatchConfig,
                                  auto_simulate, graph_sim, nab_like,
                                  plan_schedule, simulate_batch)

    app, n_iter, n_steps = CAMPAIGN.applications[0][:3]
    nodes = [nd for nd in CAMPAIGN.nodes if nd.name in (
        "miniHPC-Broadwell", "miniHPC-KNL")]
    techs = [t for t in CAMPAIGN.techniques if REGISTRY[t].meta.adaptive
             or REGISTRY[t].meta.worker_dependent]
    reps = CAMPAIGN.repetitions
    w = nab_like(n=n_iter, seed=0)
    rows = {}
    for node in nodes:
        p = node.cores
        cps = CAMPAIGN.chunk_params(w.n, p)
        cfgs = [BatchConfig(technique=t, workload=w, p=p, chunk_param=cp,
                            seed=r, timesteps=CAMPAIGN_TIMESTEPS)
                for t in techs for cp in cps for r in range(reps)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = graph_sim.simulate_batch_graph(cfgs, device=dev)
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        stats = dict(graph_sim.LAST_RUN)
        t0 = time.perf_counter()
        host = simulate_batch(cfgs)
        host_s = time.perf_counter() - t0
        rtol = 0.0 if p < 8 else 1e-9
        for cfg, g, h in zip(cfgs, graph, host):
            assert len(g) == CAMPAIGN_TIMESTEPS, (cfg.technique, len(g))
            _records_agree(f"{cfg.technique},{cfg.chunk_param} p{p}", g, h,
                           rtol)
        t_par = {t: min(sum(r.record.t_par for r in g)
                        for c, g in zip(cfgs, graph) if c.technique == t)
                 for t in techs}
        rows[node.name] = dict(
            p=p, configs=len(cfgs), chunk_params=cps, lanes=stats["lanes"],
            groups=stats["groups"], rounds=stats["rounds"],
            host_syncs=stats["syncs"], graph_wall_s=graph_s,
            host_batch_wall_s=host_s, rtol=rtol, best_sum_t_par=t_par)
        if p == nodes[0].cores:
            # the device's idle share of one technique's group
            af = [c for c in cfgs if c.technique == "af"]
            prof = device_profile(lambda: graph_sim.simulate_batch_graph(
                af, device=dev), top=4)
            rows[node.name]["profile_af"] = dict(
                lanes=graph_sim.LAST_RUN["lanes"],
                rounds=graph_sim.LAST_RUN["rounds"], **prof)

    # the selector over the campaign's techniques: graph against batch
    p = nodes[0].cores
    steps = len(CAMPAIGN.techniques) + 6
    hist = {}
    for engine in ("graph", "batch"):
        sel, h = auto_simulate(
            w, p=p, timesteps=steps, chunk_param=w.n // (4 * p),
            engine=engine, device=dev,
            selector=AutoSelector(CAMPAIGN.techniques,
                                  policy="explore_commit"))
        hist[engine] = (sel, h)
    arms = [x["technique"] for x in hist["graph"][1]]
    assert arms == [x["technique"] for x in hist["batch"][1]], "arms differ"
    np.testing.assert_allclose([x["t_par"] for x in hist["graph"][1]],
                               [x["t_par"] for x in hist["batch"][1]],
                               rtol=1e-9)
    best = str(hist["graph"][0].best)
    assert best == str(hist["batch"][0].best)

    # closed forms on the card against the host plans
    plannable = sorted(REGISTRY.graph_names(plannable=True))
    t0 = time.perf_counter()
    for name in plannable:
        kw = (dict(mu=w.mu, sigma=w.sigma) if REGISTRY[name].meta
              .requires_profiling else {})
        for node in nodes:
            for cp in (1, w.n // (4 * node.cores)):
                got = plan_schedule(f"{name},{cp},backend=graph", w.n,
                                    node.cores, device=dev, **kw)
                want = plan_schedule(name, w.n, node.cores, chunk_param=cp,
                                     **kw)
                assert got.chunks == want.chunks, (name, node.name, cp)
    plan_s = time.perf_counter() - t0
    emit("campaign", application=app, n=w.n, techniques=techs,
         repetitions=reps, timesteps=CAMPAIGN_TIMESTEPS,
         cut=f"time-steps {n_steps:,} -> {CAMPAIGN_TIMESTEPS}",
         nodes=rows,
         auto={"p": p, "steps": steps, "arms": arms, "best": best,
               "same_as_batch": True},
         plans={"techniques": plannable, "p": [nd.cores for nd in nodes],
                "equal_to_host": True, "wall_s": plan_s})


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # --dense-digest / --dense-times [SRC]: print only dense_digest() or
    # dense_times() of the package under SRC (default: this checkout's
    # src), to hold two trees' builds of flash_dense against each other
    dense_only = argv[:1] in (["--dense-digest"], ["--dense-times"])
    src = ROOT / "src"
    if dense_only and len(argv) > 1:
        src = Path(argv[1]).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} is missing; run "
              "from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    if argv[:1] == ["--dense-digest"]:
        print(json.dumps({"dense_digest": dense_digest(
            torch.device("cuda", 0)), "src": str(src)}), flush=True)
        return 0
    if argv[:1] == ["--dense-times"]:
        print(json.dumps({"dense_times": dense_times(
            torch.device("cuda", 0)), "src": str(src)}), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.build_info().get("logs", {}).values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], sm_count=n_sm,
         build_seconds=build_s, ptxas=ptxas)

    import numpy as np
    from repro_torch.balance.moe import plan_tiles
    from repro_torch.core import REGISTRY, LoopRecorder
    from repro_torch.core.torch_sched import worker_bounds
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        x = torch.randn(*shape, generator=gen, device=dev,
                        dtype=torch.float32) * scale
        return x.to(torch.bfloat16)

    # ---- inputs ------------------------------------------------------------
    q = randn(B, S, H, HD)
    k = randn(B, S, KVH, HD)
    v = randn(B, S, KVH, HD)
    kv_lens = rng.integers(64, S + 1, size=B)
    kv_lens[0] = S
    counts = np.bincount((rng.zipf(1.3, size=E * C // 2) - 1) % E,
                         minlength=E)
    expert_rows = np.minimum(counts, C)
    live = torch.arange(C, device=dev)[None, :] < torch.as_tensor(
        expert_rows, device=dev)[:, None]
    xe = randn(E, C, D_MODEL) * live[:, :, None]
    wi = randn(E, D_MODEL, D_FF, scale=D_MODEL ** -0.5)
    wo = randn(E, D_FF, D_MODEL, scale=D_FF ** -0.5)
    torch.cuda.synchronize()

    # ---- main path: counts from 0, the calls a user makes, counts read ----
    rec = LoopRecorder()
    _build.reset_launches()
    t0 = time.perf_counter()
    attn = flash_attention(q, k, v, causal=True, schedule="fac2",
                           kv_lens=kv_lens, sched_p=n_sm, recorder=rec)
    attn_p8 = flash_attention(q, k, v, causal=True, schedule="fac2",
                              kv_lens=kv_lens, sched_p=8, recorder=rec)
    hid = grouped_matmul(xe, wi, schedule="fac2", expert_rows=expert_rows,
                         block_rows=BLOCK_ROWS, sched_p=n_sm, recorder=rec)
    act = torch.nn.functional.silu(hid.float()).to(torch.bfloat16)
    ffn = grouped_matmul(act, wo, schedule="fac2", expert_rows=expert_rows,
                         block_rows=BLOCK_ROWS, sched_p=n_sm, recorder=rec)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    assert launches["flash_sched"] > 0 and launches["gmm"] > 0, launches
    for name, out, shape in (("attn", attn, (B, S, H, HD)),
                             ("ffn", ffn, (E, C, D_MODEL))):
        assert tuple(out.shape) == shape, (name, out.shape)
        assert bool(torch.isfinite(out).all()), f"{name} is not finite"
    assert torch.equal(attn, attn_p8), "sched_p=SM and sched_p=8 differ"
    assert len(rec.records) == 4 and [r.loop for r in rec.records] == [
        "flash_kv", "flash_kv", "grouped_matmul", "grouped_matmul"]
    emit("main_path", seconds=main_s, launches=launches,
         records=[{"loop": r.loop, "technique": r.technique, "p": r.p,
                   "n": r.n, "n_chunks": r.n_chunks,
                   "percent_imbalance": r.percent_imbalance}
                  for r in rec.records])

    # ---- small ragged shapes against the plain oracles -------------------
    small = {}
    for bs, ss, hs, kvhs, hd, win, bq, lens, strided in (
            (2, 300, 4, 2, 128, 0, 128, None, False),
            (3, 200, 2, 1, 64, 70, 64, None, False),
            (1, 96, 2, 2, 128, 0, 512, None, False),
            # a 128-column tile spans two 64-column kv blocks
            (2, 300, 4, 2, 128, 0, 64, None, False),
            # a window narrower than a tile, MQA
            (2, 300, 4, 1, 128, 32, 128, None, False),
            # one row past a tile; a lane of kv_len 0 (zeros)
            (3, 129, 4, 2, 128, 0, 128, [0, 129, 77], False),
            # q, k, v strided from one (b, s, 3, h, hd) buffer
            (2, 300, 4, 2, 64, 0, 128, None, True)):
        if strided:
            buf = randn(bs, ss, 3, hs, hd)
            qs, ks, vs = buf[:, :, 0], buf[:, :, 1, :kvhs], buf[:, :, 2, :kvhs]
        else:
            qs, ks, vs = randn(bs, ss, hs, hd), randn(bs, ss, kvhs, hd), \
                randn(bs, ss, kvhs, hd)
        lens = (rng.integers(1, ss + 1, size=bs) if lens is None
                else np.asarray(lens))
        got = flash_attention(qs, ks, vs, causal=True, window=win,
                              block_q=bq, block_k=bq, schedule="gss",
                              kv_lens=lens, sched_p=5)
        qf, kf, vf = fa.broadcast_flatten(qs, ks, vs)
        want = attention_ref(qf, kf, vf, causal=True, window=win,
                             kv_lens=np.repeat(lens, hs))
        want = want.reshape(bs, hs, ss, hd).permute(0, 2, 1, 3)
        key = f"flash_s{ss}_hd{hd}_w{win}_b{bq}" + ("_strided" if strided
                                                    else "")
        small[key] = check_close("flash small", got, want)
    es, cs, ds, fs = 4, 256, 96, 256
    xs, ws = randn(es, cs, ds), randn(es, ds, fs, scale=ds ** -0.5)
    rows = np.array([256, 0, 130, 7])
    got = grouped_matmul(xs, ws, schedule="fac2", expert_rows=rows,
                         block_rows=128, sched_p=3)
    tpe = cs // 128
    want = grouped_matmul_ref(xs.reshape(es * tpe, 128, ds), ws,
                              torch.arange(es * tpe, device=dev) // tpe)
    small["gmm_e4"] = check_close("gmm small", got,
                                  want.reshape(es, cs, fs))
    emit("small", max_abs_err=small)

    # ---- flash_sched at the main path's shapes ---------------------------
    qf, kf, vf = fa.broadcast_flatten(q, k, v)
    lane_lens = np.repeat(kv_lens, H)
    plain = fa.flash_attention_sched_plain(qf, kf, vf, kv_lens=lane_lens,
                                           causal=True)
    plain = plain.reshape(B, H, S, HD).permute(0, 2, 1, 3)
    flash_err = check_close("flash_sched", attn, plain)
    del plain
    for sched in IDENTITY_SCHEDULES:
        out = flash_attention(q, k, v, schedule=sched, kv_lens=kv_lens,
                              sched_p=n_sm)
        assert torch.equal(out, attn), f"flash output differs for {sched}"
    s_small = 1024
    qs, ks, vs = q[:, :s_small].contiguous(), k[:, :s_small].contiguous(), \
        v[:, :s_small].contiguous()
    lens_small = np.minimum(kv_lens, s_small)
    base = None
    for tech in REGISTRY:
        out = flash_attention(qs, ks, vs, schedule=tech, kv_lens=lens_small,
                              sched_p=n_sm)
        base = out if base is None else base
        assert torch.equal(out, base), f"flash output differs for {tech}"

    def flash_plan(schedule, p):
        d, pl = fa._plan_kv_descriptors(
            B * H, S, 512, 512, causal=True, window=0, kv_lens=lane_lens,
            schedule=schedule, p=p)
        return d, fa.descriptor_bounds(d, pl), pl

    def flash_kernel(schedule, p):
        d, bd, _ = flash_plan(schedule, p)
        return lambda: fa._flash_sched_cuda(
            q, k, v, d, bd, block_q=512, block_k=512, causal=True, window=0)

    def flash_kernel_ms(schedule, p, n):
        return cuda_ms(flash_kernel(schedule, p), n)

    desc, bounds, plan = flash_plan("fac2", n_sm)
    plan8 = flash_plan("fac2", 8)[2]
    flash_ms = flash_kernel_ms("fac2", n_sm, REPS)
    flash_ms_b2b = cuda_ms_b2b(flash_kernel("fac2", n_sm), REPS)
    tiles, tiles_cta = sched_tiles(desc, bounds, 512, 512)
    # probe: self-scheduling (one group a chunk) balances this plan to
    # within 1%, so it shows the kernel's rate apart from fac2's balance
    desc_ss, bounds_ss, plan_ss = flash_plan("ss", n_sm)
    tiles_cta_ss = sched_tiles(desc_ss, bounds_ss, 512, 512)[1]
    flash_ms_b2b_ss = cuda_ms_b2b(flash_kernel("ss", n_sm), REPS)
    flash_ms_static = flash_kernel_ms("static", n_sm, REPS)
    flash_ms_p8 = flash_kernel_ms("fac2", 8, max(3, REPS // 4))
    flash_ms_p8_static = flash_kernel_ms("static", 8, max(3, REPS // 4))
    call_ms = cuda_ms(lambda: flash_attention(
        q, k, v, schedule="fac2", kv_lens=kv_lens, sched_p=n_sm), REPS)
    plan_split = plan_split_ms(fa, lane_lens, n_sm, dev)
    plain_ms = cuda_ms(lambda: fa.flash_attention_sched_plain(
        qf, kf, vf, kv_lens=lane_lens, causal=True), 3)
    del qf, kf, vf
    # yardstick only: one PyTorch call for the same function
    qt = q.permute(0, 2, 1, 3)
    kt, vt = (x.permute(0, 2, 1, 3).repeat_interleave(H // KVH, dim=1)
              for x in (k, v))
    idx = torch.arange(S, device=dev)
    mask = (idx[None, :] <= idx[:, None])[None, None] & (
        idx[None, None, None, :] < torch.as_tensor(
            kv_lens, device=dev)[:, None, None, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def run_sdpa():
        return sdpa(qt, kt, vt, attn_mask=mask)

    library_ms = cuda_ms(run_sdpa, REPS)
    sdpa_err = float((run_sdpa().permute(0, 2, 1, 3).float()
                      - attn.float()).abs().max())
    del mask, qt, kt, vt
    pairs = sum(H * int(np.minimum(np.arange(1, S + 1), lim).sum())
                for lim in kv_lens)
    flash_flops = 4 * HD * pairs
    flash_bytes = 2 * (2 * B * S * H * HD
                       + 2 * KVH * HD * int(np.minimum(kv_lens, S).sum()))
    flash_bound = 1e3 * max(flash_flops / PEAK_BF16_FLOPS,
                            flash_bytes / PEAK_BYTES)
    emit("flash_sched", shape=[B, S, H, KVH, HD], kv_lens=kv_lens.tolist(),
         max_abs_err=flash_err, sdpa_max_abs_diff=sdpa_err,
         identical_schedules=list(IDENTITY_SCHEDULES),
         identical_techniques_s1024=len(REGISTRY),
         ms=flash_ms, ms_b2b=flash_ms_b2b, ms_static=flash_ms_static,
         ms_sched_p8=flash_ms_p8, ms_sched_p8_static=flash_ms_p8_static,
         call_ms_with_planning=call_ms, plan_split_ms=plan_split,
         live_tiles=tiles, live_tiles_max_cta=tiles_cta,
         us_per_tile_max_cta=1e3 * flash_ms_b2b / tiles_cta,
         ms_b2b_ss=flash_ms_b2b_ss, live_tiles_max_cta_ss=tiles_cta_ss,
         percent_imbalance_ss=plan_ss.percent_imbalance,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=flash_bound,
         flops=flash_flops, bytes=flash_bytes, groups=int(plan.n),
         descriptors=int(desc[0].shape[0]),
         percent_imbalance=plan.percent_imbalance,
         percent_imbalance_p8=plan8.percent_imbalance)

    # ---- gmm at the main path's shapes (wi and wo) -----------------------
    gmm_rows = {}
    for name, x, w, y in (("wi", xe, wi, hid), ("wo", act, wo, ffn)):
        e_, c_, d_ = x.shape
        f_ = w.shape[2]
        tpe = c_ // BLOCK_ROWS
        x_tiles = x.reshape(e_ * tpe, BLOCK_ROWS, d_)
        tile_expert = torch.arange(e_ * tpe, device=dev,
                                   dtype=torch.int32) // tpe
        plain = gm.grouped_matmul_tiles_plain(x_tiles, w, tile_expert)
        err = check_close(f"gmm {name}", y, plain.reshape(e_, c_, f_))
        del plain
        for sched in ("static", "ss", "gss", "awf_b", "dls_steal"):
            out = grouped_matmul(x, w, schedule=sched,
                                 expert_rows=expert_rows,
                                 block_rows=BLOCK_ROWS, sched_p=n_sm)
            assert torch.equal(out, y), f"gmm {name} differs for {sched}"
        for kw in ({"schedule": "fac2", "expert_rows": expert_rows,
                    "sched_p": 8}, {"sched_p": n_sm}):
            out = grouped_matmul(x, w, block_rows=BLOCK_ROWS, **kw)
            assert torch.equal(out, y), f"gmm {name} differs for {kw}"
        xt = x_tiles.contiguous()

        def gmm_kernel(schedule):
            order, gp = plan_tiles(expert_rows, BLOCK_ROWS, p=n_sm,
                                   technique=schedule, capacity_rows=c_,
                                   return_plan=True)
            gb = worker_bounds(gp.step_worker, n_sm)
            return (lambda: gm.gmm_cuda(xt, w, tile_expert, order, gb,
                                        gp.n)), gp

        run_fac2, gplan = gmm_kernel("fac2")
        ms = cuda_ms(run_fac2, REPS)
        ms_static = cuda_ms(gmm_kernel("static")[0], REPS)
        # back to back, so that the wrapper's host work drops out: the fac2
        # order; the identity order split into n_sm spans (an expert's tiles
        # one after another on one CTA); the same with every tile on expert
        # 0, whose weights then stay in L2 (another function: timing only)
        t_ = e_ * tpe
        ident = (np.arange(t_, dtype=np.int32), gm.span_bounds(t_, n_sm), t_)
        expert0 = torch.zeros_like(tile_expert)
        ms_b2b = {
            "fac2": cuda_ms_b2b(run_fac2, REPS),
            "identity": cuda_ms_b2b(
                lambda: gm.gmm_cuda(xt, w, tile_expert, *ident), REPS),
            "identity_expert0": cuda_ms_b2b(
                lambda: gm.gmm_cuda(xt, w, expert0, *ident), REPS)}
        p_ms = cuda_ms(lambda: gm.grouped_matmul_tiles_plain(
            xt, w, tile_expert), 3)
        lib_ms = cuda_ms(lambda: torch.bmm(x, w), REPS)
        # every tile, live or dead, as the TPU kernel's CostEstimate counts
        # it: the kernel and torch.bmm both compute the dead tiles too
        rows_all = e_ * c_
        flops = 2 * rows_all * d_ * f_
        nbytes = 2 * (rows_all * d_ + e_ * d_ * f_ + rows_all * f_)
        gmm_rows[name] = dict(
            max_abs_err=err, ms=ms, ms_static=ms_static, ms_b2b=ms_b2b,
            plain_ms=p_ms, library_ms=lib_ms,
            library_ms_b2b=cuda_ms_b2b(lambda: torch.bmm(x, w), REPS),
            bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
            flops=flops, bytes=nbytes, live_tiles=int(gplan.n),
            tiles=int(e_ * tpe), percent_imbalance=gplan.percent_imbalance)
    emit("gmm", expert_rows=expert_rows.tolist(), shapes={
        "wi": [E, C, D_MODEL, D_FF], "wo": [E, C, D_FF, D_MODEL]},
        **gmm_rows)

    def total(key):
        return sum(r[key] for r in gmm_rows.values())

    # ---- this slice: the dense kernel, prefill and serving of qwen3-4b ----
    del q, k, v, xe, wi, wo, hid, act, ffn, attn, attn_p8, live
    torch.cuda.empty_cache()
    dense = phase_flash_dense(dev, randn)
    from repro_torch.configs import get_arch
    from repro_torch.models import init_decoder
    cfg = get_arch(ARCH)
    params, _ = init_decoder(0, cfg, device=dev)
    prefill_launches = phase_prefill(dev, cfg, params)
    phase_serve(dev, cfg, params)
    del params
    torch.cuda.empty_cache()

    # ---- this slice: the MoE and recurrent families --------------------
    moe_cfg, moe_params, moe_launches, gmm_model = phase_moe_prefill(
        dev, n_sm, randn)
    serve_launches = phase_moe_serve(dev, moe_cfg, moe_params)
    del moe_params
    torch.cuda.empty_cache()
    recurrent_launches = {arch: phase_recurrent(dev, arch)
                          for arch in RECURRENT_ARCHS}

    # ---- this slice: stablelm-3b (head dim 80) and the campaign engine ----
    cfg = get_arch(DENSE80_ARCH)
    params, _ = init_decoder(0, cfg, device=dev)
    dense80_launches = phase_prefill(dev, cfg, params, phase="prefill_80",
                                     parity=False)
    assert dense80_launches["flash_dense"] == cfg.num_layers
    del params
    torch.cuda.empty_cache()
    phase_campaign(dev)

    gmm_flops = total("flops")
    gmm_bytes = total("bytes")
    kernels = [
        {"name": "flash_sched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_sched.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:168",
         "launches": launches["flash_sched"], "max_abs_err": flash_err,
         "tolerance": f"{ATOL} + {RTOL}*|plain|",
         "ms": flash_ms, "plain_ms": plain_ms, "bound_ms": flash_bound,
         "bound_by": ("operations" if flash_flops / PEAK_BF16_FLOPS
                      >= flash_bytes / PEAK_BYTES else "bytes"),
         "library_ms": library_ms,
         "percent_imbalance": plan.percent_imbalance},
        {"name": "gmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gmm.cu",
         "replaces": "src/repro/kernels/grouped_matmul/grouped_matmul.py:37",
         "launches": (launches["gmm"] + moe_launches["gmm"]
                      + serve_launches["gmm"]),
         "launches_by_path": {"main_path": launches["gmm"],
                              "moe_prefill": moe_launches["gmm"],
                              "moe_serve": serve_launches["gmm"]},
         "max_abs_err": max(r["max_abs_err"] for r in gmm_rows.values()),
         "tolerance": f"{ATOL} + {RTOL}*|plain|",
         "ms": total("ms"), "plain_ms": total("plain_ms"),
         "bound_ms": total("bound_ms"),
         "bound_by": ("operations" if gmm_flops / PEAK_BF16_FLOPS
                      >= gmm_bytes / PEAK_BYTES else "bytes"),
         "library_ms": total("library_ms"),
         "percent_imbalance": gmm_rows["wi"]["percent_imbalance"],
         "model_path": {k: gmm_model[k] for k in (
             "ms", "ms_b2b", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "shapes")}},
        {"name": "flash_dense", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_dense.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:51",
         "launches": (prefill_launches["flash_dense"]
                      + moe_launches["flash_dense"]
                      + dense80_launches["flash_dense"]
                      + recurrent_launches["recurrentgemma-2b"][
                          "flash_dense"]),
         "launches_by_path": {
             "prefill": prefill_launches["flash_dense"],
             "moe_prefill": moe_launches["flash_dense"],
             "prefill_80": dense80_launches["flash_dense"],
             "recurrentgemma_prefill": recurrent_launches[
                 "recurrentgemma-2b"]["flash_dense"]},
         "tolerance": f"{ATOL} + {RTOL}*|plain|", **dense},
    ]
    for kern in kernels:
        assert all(math.isfinite(kern[x]) for x in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
