"""GQA/MQA attention: RoPE, optional qk-norm, causal + sliding-window
masks, flash-style KV-block streaming for long sequences, and a ring-buffer
KV cache for decode.  Port of ``src/repro/models/attention.py``.

Paths:
  * `full`   — one einsum; used for short sequences.
  * `flash`  — above ``cfg.flash_threshold``.  On a CUDA tensor it launches
               the dense flash kernel (``kernels/flash_attention``,
               ``csrc/flash_dense.cu``), which reads the KV heads in place
               and takes every head dim the configs use (64, 80, 128, 256:
               any multiple of 8 up to 256); an unsupported dtype or head
               dim raises there, with no fallback.  On a CPU
               tensor `_attend_flash` computes the same function: the
               reference's online softmax over KV blocks of 1024, a Python
               loop where the reference has ``lax.scan``.
  * `decode` — single query position against the KV cache.  The cache is
               updated in place (an indexed write where the reference
               returns a new array) and returned.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.stand_ins import flash_meta
from ..sharding import Ax, is_dtensor, merge_last, shard_as, split_last
from .layers import apply_rope, dense_init, rms_norm, use_weight

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg):
    hd = cfg.resolved_head_dim
    params = {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, "embed", "heads")[0],
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, "embed", "kv_heads")[0],
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, "embed", "kv_heads")[0],
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, "heads", "embed")[0],
    }
    axes = {
        "wq": Ax("embed", "heads"),
        "wk": Ax("embed", "kv_heads"),
        "wv": Ax("embed", "kv_heads"),
        "wo": Ax("heads", "embed"),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((hd,), device=gen.device)
        params["k_norm"] = torch.ones((hd,), device=gen.device)
        axes["q_norm"] = Ax("head_dim")
        axes["k_norm"] = Ax("head_dim")
    return params, axes


class KVCache(NamedTuple):
    """KV cache; sized to the window (ring buffer) when window > 0 —
    ring-ness is derived from the `window` argument at the call sites."""

    k: torch.Tensor    # (b, S, kv_heads, hd)   S = max_len (or window)
    v: torch.Tensor
    pos: torch.Tensor  # (b,) int32: absolute position of next token per lane


class KVCacheQ(NamedTuple):
    """Int8-quantized KV cache (per-token, per-kv-head max-abs scales)."""

    k: torch.Tensor        # int8 (b, S, kvh, hd)
    v: torch.Tensor
    k_scale: torch.Tensor  # f32 (b, S, kvh)
    v_scale: torch.Tensor
    pos: torch.Tensor


def _cache_shape(cfg, batch: int, max_len: int, window: int):
    size = min(window, max_len) if window else max_len
    return (batch, size, cfg.num_kv_heads, cfg.resolved_head_dim)


def init_kv_cache(cfg, batch: int, max_len: int, window: int = 0,
                  dtype=torch.bfloat16, *, device=None) -> KVCache:
    dev = resolve_device(device)
    shape = _cache_shape(cfg, batch, max_len, window)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))


def init_kv_cache_q(cfg, batch: int, max_len: int, window: int = 0, *,
                    device=None) -> KVCacheQ:
    dev = resolve_device(device)
    shape = _cache_shape(cfg, batch, max_len, window)
    return KVCacheQ(
        k=torch.zeros(shape, dtype=torch.int8, device=dev),
        v=torch.zeros(shape, dtype=torch.int8, device=dev),
        k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=dev),
        v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))


def kv_cache_specs(cfg, batch: int, max_len: int, window: int = 0,
                   dtype=torch.bfloat16) -> KVCache:
    """``init_kv_cache``'s tensors on the meta device (shape and dtype, no
    storage), the reference's ShapeDtypeStruct version."""
    shape = _cache_shape(cfg, batch, max_len, window)
    return KVCache(k=torch.empty(shape, dtype=dtype, device="meta"),
                   v=torch.empty(shape, dtype=dtype, device="meta"),
                   pos=torch.empty((batch,), dtype=torch.int32, device="meta"))


def kv_cache_q_specs(cfg, batch: int, max_len: int, window: int = 0
                     ) -> KVCacheQ:
    """``init_kv_cache_q``'s tensors on the meta device."""
    shape = _cache_shape(cfg, batch, max_len, window)

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    return KVCacheQ(k=meta(shape, torch.int8), v=meta(shape, torch.int8),
                    k_scale=meta(shape[:3], torch.float32),
                    v_scale=meta(shape[:3], torch.float32),
                    pos=meta((batch,), torch.int32))


def _quantize_token(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (b, 1, kvh, hd) -> (int8 values, f32 scale (b, 1, kvh)).

    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _project_qkv(params, cfg, x, sin, cos):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    wq = use_weight(params["wq"].to(dt), cfg, None, "heads")
    wk = use_weight(params["wk"].to(dt), cfg, None, "kv_heads")
    wv = use_weight(params["wv"].to(dt), cfg, None, "kv_heads")
    q = split_last(x @ wq, cfg.num_heads, "batch", "seq", "heads")
    k = split_last(x @ wk, cfg.num_kv_heads, "batch", "seq", "kv_heads")
    v = split_last(x @ wv, cfg.num_kv_heads, "batch", "seq", "kv_heads")
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    q = shard_as(q, "batch", "seq", "heads", "head_dim")
    k = shard_as(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard_as(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(b, s, kvh, hd) -> (b, s, h, hd) broadcast across groups."""
    b, s, kvh, hd = k.shape
    g = num_heads // kvh
    if g == 1:
        return k
    k = k[:, :, :, None, :].expand(b, s, kvh, g, hd).reshape(b, s, num_heads,
                                                            hd)
    return shard_as(k, "batch", "seq", "heads", "head_dim")


def _mask(si: torch.Tensor, sj: torch.Tensor, window: int) -> torch.Tensor:
    """(i, j) allowed?  causal, optional sliding window."""
    m = sj[None, :] <= si[:, None]
    if window > 0:
        m &= (si[:, None] - sj[None, :]) < window
    return m


def _attend_full(q, k, v, cfg, window: int):
    """Single-einsum attention (short sequences)."""
    b, s, h, hd = q.shape
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    scores = shard_as(scores, "batch", "heads", "seq", None)
    idx = torch.arange(s, device=q.device)
    mask = _mask(idx, idx, window)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _attend_flash(q, k, v, cfg, window: int, block: int = 1024):
    """Online-softmax streaming over KV blocks (the plain flash version).

    Memory is O(s * block) instead of O(s^2).  The same math as the dense
    flash kernel; every block is visited, as in the reference."""
    b, s, h, hd = q.shape
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = 1.0 / math.sqrt(hd)
    nb = (s + block - 1) // block
    pad = nb * block - s
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qi = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, hd), dtype=torch.float32, device=q.device)
    for jblk in range(nb):
        kj = k[:, jblk * block:(jblk + 1) * block]
        vj = v[:, jblk * block:(jblk + 1) * block]
        kidx = jblk * block + torch.arange(block, device=q.device)
        sc = torch.einsum("bshd,bthd->bhst", q, kj).float() * scale
        sc = shard_as(sc, "batch", "heads", "seq", None)
        msk = kidx[None, :] <= qi[:, None]  # (s, block) causal
        if window > 0:
            msk &= (qi[:, None] - kidx[None, :]) < window
        msk &= (kidx < s)[None, :]
        sc = torch.where(msk[None, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bthd->bhsd", p.to(q.dtype), vj).float()
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _flash_local(q, k, v, window: int):
    """The dense flash kernel on one shard: launched on the card, its
    plain version on the CPU, its shape-only stand-in on meta."""
    if q.is_meta:
        return flash_meta(q, k, v, window)
    return flash_attention(q, k, v, causal=True, window=window)


def _flash_sharded(q, k, v, window: int):
    """Flash attention on DTensors: the kernel on each rank's local shard
    (``local_map``).  The kernel takes whole sequences (no causal offset)
    and all kv heads of its q heads, so q keeps only its batch and head
    shards (a sequence shard is gathered); kv heads are sharded with the
    q heads where their count allows, else replicated, and each rank
    slices the kv heads its q heads read."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    qpl = [p if p in (Shard(0), Shard(2)) else Replicate()
           for p in q.placements]
    n_head = math.prod(mesh.size(i) for i, p in enumerate(qpl)
                       if p == Shard(2))
    hq = h // n_head
    kv_split = kvh % n_head == 0
    if not kv_split:
        # every rank's q heads must read a run of kv heads that the
        # kernel's own grouping (hq / n_kv q heads a kv head) maps right
        for q0 in range(0, h, hq):
            kv0, kv1 = q0 // g, (q0 + hq - 1) // g + 1
            if hq % (kv1 - kv0) or any(
                    (q0 + j) // g - kv0 != j // (hq // (kv1 - kv0))
                    for j in range(hq)):
                qpl = [Replicate() if p == Shard(2) else p for p in qpl]
                break
    kvpl = [p if p == Shard(0) or (p == Shard(2) and kv_split)
            else Replicate() for p in qpl]
    shape, offset = compute_local_shape_and_global_offset(q.shape, mesh,
                                                          qpl)
    q0, hq = offset[2], shape[2]

    def local(ql, kl, vl):
        if kl.shape[2] == kvh and hq < h:
            kv0, kv1 = q0 // g, (q0 + hq - 1) // g + 1
            kl, vl = kl[:, :, kv0:kv1], vl[:, :, kv0:kv1]
        return _flash_local(ql, kl, vl, window)

    # a kv head shared by the q heads of several ranks gets a partial
    # gradient on each
    kv_grad = [Partial() if p == Shard(2) and kp == Replicate() else kp
               for p, kp in zip(qpl, kvpl)]
    return local_map(local, out_placements=list(qpl),
                     in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def attention(params, cfg, x, sin, cos, *, window: int = 0):
    """Train/prefill attention.  x: (b, s, d) -> (b, s, d)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, sin, cos)
    if s > cfg.flash_threshold:
        if is_dtensor(q):
            ctx = _flash_sharded(q, k, v, window)
        elif q.device.type == "cuda":
            ctx = flash_attention(q, k, v, causal=True, window=window)
        else:
            ctx = _attend_flash(q, k, v, cfg, window)
    else:
        ctx = _attend_full(q, k, v, cfg, window)
    ctx = merge_last(ctx, "batch", "seq", "heads")
    wo = use_weight(params["wo"].to(x.dtype), cfg, "heads", None)
    out = ctx @ wo
    return shard_as(out, "batch", "seq", "embed_act")


def _set_slot(buf, lanes, slot, inside, val):
    """``buf[lanes, slot] = val`` in place, keeping the old entry of every
    lane where ``inside`` is False (``None``: every lane writes)."""
    if is_dtensor(buf):
        return _set_slot_sharded(buf, slot, inside, val)
    if inside is not None:
        keep = inside.view(-1, *([1] * (val.dim() - 1)))
        val = torch.where(keep, val, buf[lanes, slot])
    buf[lanes, slot] = val


def _set_slot_sharded(buf, slot, inside, val):
    """``_set_slot`` on a DTensor cache (batch x ``seq_cache`` shards):
    under ``local_map`` each rank writes the slots its shard holds, the
    slot less the shard's offset; the cache's layout does not move."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = buf.device_mesh, tuple(buf.placements)
    lane_pl = tuple(p if p == Shard(0) else Replicate() for p in pl)
    val_pl = tuple(p if p == Shard(0) else
                   Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                   else Replicate() for p in pl)
    _, offset = compute_local_shape_and_global_offset(buf.shape, mesh, pl)

    def write(b, sl, ins, v):
        here = sl - offset[1]
        ins = (here >= 0) & (here < b.shape[1]) & (True if ins is None
                                                   else ins)
        here = here.clamp(0, b.shape[1] - 1)
        lanes = torch.arange(b.shape[0], device=b.device)
        keep = ins.view(-1, *([1] * (v.dim() - 1)))
        b[lanes, here] = torch.where(keep, v, b[lanes, here])
        return (b,)

    local_map(write, out_placements=(pl,),
              in_placements=(pl, lane_pl,
                             None if inside is None else lane_pl, val_pl),
              device_mesh=mesh, redistribute_inputs=True)(buf, slot, inside,
                                                          val)


def attention_decode(params, cfg, x, sin, cos, cache, *, window: int = 0):
    """One-token decode.  x: (b, 1, d); cache holds past KV (bf16 KVCache
    or int8 KVCacheQ).  Writes the new token's K/V into the cache and
    advances its ``pos`` in place; returns (out, cache)."""
    b, s, _ = x.shape
    assert s == 1
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x, sin, cos)
    size = cache.k.shape[1]
    ring = window > 0
    # per-lane positions: each batch lane writes at its own slot
    lanes = torch.arange(b, device=x.device)
    pos = cache.pos.long()
    if ring:
        slot, inside = torch.remainder(pos, size), None         # (b,)
    else:
        # a lane past the cache's end writes nothing, as the reference's
        # scatter drops an out-of-bounds update.  Only an idle engine lane
        # gets there, but a lane admitted for the first time is not reset
        # (as in the reference), so a request may then decode in it and
        # must read what the reference's cache holds
        slot, inside = torch.clamp_max(pos, size - 1), pos < size
    quant = isinstance(cache, KVCacheQ)
    if quant:
        kq, ks = _quantize_token(k)
        vq, vs = _quantize_token(v)
        _set_slot(cache.k, lanes, slot, inside, kq[:, 0])
        _set_slot(cache.v, lanes, slot, inside, vq[:, 0])
        _set_slot(cache.k_scale, lanes, slot, inside, ks[:, 0])
        _set_slot(cache.v_scale, lanes, slot, inside, vs[:, 0])
    else:
        _set_slot(cache.k, lanes, slot, inside, k[:, 0].to(cache.k.dtype))
        _set_slot(cache.v, lanes, slot, inside, v[:, 0].to(cache.v.dtype))
    h = cfg.num_heads
    kvh = cfg.num_kv_heads
    g = h // kvh
    # decode keeps KV un-repeated (grouped einsum): the cache is the
    # memory-bound object
    # under a mesh q's heads are first laid out as whole kv groups
    q = shard_as(q, "batch", "seq", "kv_heads", "head_dim",
                 shape=(b, 1, kvh, hd))
    qg = q.reshape(b, kvh, g, hd)
    scale = 1.0 / math.sqrt(hd)
    if quant:
        # contract against int8 values; fold the per-token scale into the
        # scores/probs afterwards
        sc = torch.einsum("bkgd,btkd->bkgt", qg.float(), cache.k.float())
        sc = sc * cache.k_scale.permute(0, 2, 1)[:, :, None, :] * scale
    else:
        kf = cache.k.to(q.dtype)
        vf = cache.v.to(q.dtype)
        sc = torch.einsum("bkgd,btkd->bkgt", qg, kf).float() * scale
    # validity per lane: slot t holds absolute position
    # (ring: pos - ((slot-t) mod S))
    t = torch.arange(size, device=x.device)
    if ring:
        age = torch.remainder(slot[:, None] - t[None, :] + size, size)
        valid = age <= torch.clamp_max(pos, size - 1)[:, None]
        valid &= age < window
    else:
        valid = t[None, :] <= pos[:, None]                           # (b,S)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    probs = torch.softmax(sc, dim=-1)
    if quant:
        pw = probs * cache.v_scale.permute(0, 2, 1)[:, :, None, :]
        ctx = torch.einsum("bkgt,btkd->bkgd", pw,
                           cache.v.float()).to(q.dtype)
    else:
        ctx = torch.einsum("bkgt,btkd->bkgd", probs.to(q.dtype), vf)
    ctx = ctx.reshape(b, 1, h * hd)
    out = ctx @ params["wo"].to(x.dtype)
    out = shard_as(out, "batch", "seq", "embed_act")
    cache.pos.add_(1)
    return out, cache

