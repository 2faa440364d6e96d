"""Unified decoder LM covering all 10 architectures.  Port of
``src/repro/models/decoder.py``.

Layer stacking as in the reference: the block pattern (e.g. ('attn',) or
('rglru','rglru','local_attn') or 7x'mlstm'+1x'slstm') is tiled over
num_layers as ``G full groups + R remainder layers``.  Group parameters are
stacked with a leading G axis and run by a Python loop over the groups
(the reference's ``lax.scan``); remainder layers are unrolled.

Decode: per-layer caches (KV ring buffers / recurrent states) are stacked
per pattern position the same way.  They are updated in place: a layer's
cache is a view of its slice of the stacked tensors, written by indexed
writes or ``copy_`` where the reference's ``dynamic_update_index_in_dim``
returns a new array.  ``decode_step`` returns the state it was given,
advanced.

Training: ``loss_fn`` is the reference's chunked next-token CE plus z-loss
plus the MoE aux loss; each ``cfg.loss_chunk``-position chunk's unembed
and CE run under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` inside ``lax.scan``), so the (b, s, vocab) logits are
never held.  The group loop runs under ``_remat``: ``"full"`` recomputes a
group's blocks in the backward, ``"dots"`` saves only the matmul outputs
(selective checkpointing, the reference's ``checkpoint_dots``), ``"none"``
saves everything.  Remat applies only where autograd records: a forward
under ``torch.no_grad()``, or on parameters that do not require grad, runs
the blocks as they are.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..sharding import Ax
from ..tree import tree_leaves, tree_map
from .attention import (
    KVCache,
    KVCacheQ,
    attention,
    attention_decode,
    init_attention,
    init_kv_cache,
    init_kv_cache_q,
    kv_cache_q_specs,
    kv_cache_specs,
)
from .layers import (
    dtype_of,
    embed_init,
    embed_tokens,
    norm_init,
    rms_norm,
    rope_tables,
    softcap,
    unembed_logits,
)
from .mlp import init_mlp, mlp
from .moe import init_moe, moe
from .recurrent import (
    MLSTMState,
    RGLRUState,
    SLSTMState,
    init_mlstm,
    init_mlstm_state,
    init_rglru,
    init_rglru_state,
    init_slstm,
    init_slstm_state,
    mlstm_decode,
    mlstm_parallel,
    rglru,
    rglru_decode,
    slstm,
    slstm_decode,
)

_MIXER_INIT = {
    "attn": init_attention,
    "local_attn": init_attention,
    "mlstm": init_mlstm,
    "slstm": init_slstm,
    "rglru": init_rglru,
}


def _has_ffn(cfg) -> bool:
    return cfg.d_ff > 0 or cfg.moe is not None


# ---------------------------------------------------------------------------
# block init / apply
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg, kind: str):
    mix_p, mix_a = _MIXER_INIT[kind](gen, cfg)
    params = {"norm1": norm_init(cfg.d_model, device=gen.device)[0],
              "mixer": mix_p}
    axes = {"norm1": Ax("embed"), "mixer": mix_a}
    if _has_ffn(cfg):
        ff_p, ff_a = (init_moe if cfg.moe is not None else init_mlp)(gen, cfg)
        params["norm2"] = norm_init(cfg.d_model, device=gen.device)[0]
        params["ffn"] = ff_p
        axes["norm2"] = Ax("embed")
        axes["ffn"] = ff_a
    return params, axes


def block_apply(params, cfg, kind: str, x, sin, cos):
    """Training/prefill block: returns (x, aux_loss)."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    window = cfg.window if kind == "local_attn" else 0
    if kind in ("attn", "local_attn"):
        mix = attention(params["mixer"], cfg, h, sin, cos, window=window)
    elif kind == "mlstm":
        mix, _ = mlstm_parallel(params["mixer"], cfg, h)
    elif kind == "slstm":
        mix, _ = slstm(params["mixer"], cfg, h)
    elif kind == "rglru":
        mix, _ = rglru(params["mixer"], cfg, h)
    else:
        raise KeyError(kind)
    x = x + mix
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe is not None:
        h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
        y, aux_l, _load = moe(params["ffn"], cfg, h2)
        x = x + y
        aux = aux + aux_l
    elif cfg.d_ff > 0:
        h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
        x = x + mlp(params["ffn"], cfg, h2)
    return x, aux


def block_decode(params, cfg, kind: str, x, sin, cos, cache):
    """One-token block; ``cache`` is updated in place and returned."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    window = cfg.window if kind == "local_attn" else 0
    if kind in ("attn", "local_attn"):
        mix, cache = attention_decode(params["mixer"], cfg, h, sin, cos,
                                      cache, window=window)
    elif kind == "mlstm":
        mix, cache = mlstm_decode(params["mixer"], cfg, h, cache)
    elif kind == "slstm":
        mix, cache = slstm_decode(params["mixer"], cfg, h, cache)
    elif kind == "rglru":
        mix, cache = rglru_decode(params["mixer"], cfg, h, cache)
    else:
        raise KeyError(kind)
    x = x + mix
    if _has_ffn(cfg):
        h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
        if cfg.moe is not None:
            y, _aux, _load = moe(params["ffn"], cfg, h2)
        else:
            y = mlp(params["ffn"], cfg, h2)
        x = x + y
    return x, cache


# ---------------------------------------------------------------------------
# decoder init
# ---------------------------------------------------------------------------


def _group_split(cfg) -> tuple[int, tuple[str, ...], tuple[str, ...]]:
    period = len(cfg.block_pattern)
    g = cfg.num_layers // period
    return g, cfg.block_pattern, cfg.pattern_layers[g * period:]


def _stack_init(init_fn, n: int):
    outs = [init_fn() for _ in range(n)]
    params = tree_map(lambda *a: torch.stack(a), *[p for p, _ in outs])
    axes = tree_map(lambda ax: Ax("stack", *ax.names), outs[0][1])
    return params, axes


def init_decoder(seed: int, cfg, *, device=None):
    """(params, axes) of the decoder, drawn from ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    return _init_decoder(torch.Generator(device=dev).manual_seed(int(seed)),
                         cfg)


def _init_decoder(gen: torch.Generator, cfg):
    g, pattern, remainder = _group_split(cfg)
    params: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    params["embed"], axes["embed"] = embed_init(gen, cfg.padded_vocab,
                                                cfg.d_model)
    if not cfg.tie_embeddings:
        params["unembed"], axes["unembed"] = embed_init(
            gen, cfg.padded_vocab, cfg.d_model)
    params["final_norm"] = norm_init(cfg.d_model, device=gen.device)[0]
    axes["final_norm"] = Ax("embed")

    grp_p, grp_a = [], []
    if g > 0:
        for kind in pattern:
            p, a = _stack_init(lambda kind=kind: init_block(gen, cfg, kind), g)
            grp_p.append(p)
            grp_a.append(a)
    params["groups"] = tuple(grp_p)
    axes["groups"] = tuple(grp_a)

    rem_p, rem_a = [], []
    for kind in remainder:
        p, a = init_block(gen, cfg, kind)
        rem_p.append(p)
        rem_a.append(a)
    params["remainder"] = tuple(rem_p)
    axes["remainder"] = tuple(rem_a)
    return params, axes


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: the initialisers allocate
    on ``gen.device``, and on the meta device they draw nothing."""

    @property
    def device(self):
        return torch.device("meta")


def decoder_param_specs(cfg):
    """(parameter tree on the meta device, axes tree): shapes and dtypes
    without allocation, the reference's ``eval_shape`` of
    ``init_decoder``."""
    return _init_decoder(_MetaGenerator(), cfg)


def init_decoder_axes(cfg):
    """Axes tree without allocating params."""
    return decoder_param_specs(cfg)[1]


def _layers(params, cfg):
    """(kind, layer params, group index, pattern position) in depth order;
    group layers are views into the stacked tensors (index -1: remainder)."""
    g, pattern, remainder = _group_split(cfg)
    for gi in range(g):
        for pi, kind in enumerate(pattern):
            yield kind, tree_map(lambda a: a[gi], params["groups"][pi]), gi, pi
    for ri, kind in enumerate(remainder):
        yield kind, params["remainder"][ri], -1, ri


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


#: the matmuls whose outputs ``remat="dots"`` keeps (``checkpoint_dots``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _records(*tensors) -> bool:
    """Will autograd record an op on ``tensors``?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _remat(fn, policy: str, records: bool):
    """``fn`` under the remat ``policy`` ('none' | 'dots' | 'full') where
    autograd ``records``; as it is otherwise (a checkpoint around a forward
    that saves nothing only costs host time)."""
    if policy == "none" or not records:
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(_DOTS))
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _hidden_states(params, cfg, tokens, prefix_embed=None):
    """Shared trunk of forward() up to the final norm (no unembed)."""
    compute = dtype_of(cfg.compute_dtype)
    x = embed_tokens(params["embed"], tokens, compute)
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(compute), x], dim=1)
    s = x.shape[1]
    sin, cos = rope_tables(torch.arange(s, device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    g, pattern, remainder = _group_split(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group_body(x, aux, gi):
        for pi, kind in enumerate(pattern):
            layer = tree_map(lambda a: a[gi], params["groups"][pi])
            x, a = block_apply(layer, cfg, kind, x, sin, cos)
            aux = aux + a
        return x, aux

    body = _remat(group_body, cfg.remat,
                  _records(x, *tree_leaves(params["groups"])))
    for gi in range(g):
        x, aux = body(x, aux, gi)
    for ri, kind in enumerate(remainder):
        x, a = block_apply(params["remainder"][ri], cfg, kind, x, sin, cos)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def forward(params, cfg, tokens, prefix_embed=None):
    """tokens (b, s_body) [+ prefix (b, P, d)] -> logits (b, s, v), aux."""
    x, aux = _hidden_states(params, cfg, tokens, prefix_embed)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed_logits(x, table, cfg)
    return softcap(logits, cfg.logit_softcap), aux


def loss_fn(params, cfg, tokens, labels, prefix_embed=None,
            z_loss: float = 1e-4):
    """Next-token CE over the token body (prefix positions excluded).

    The logits are never materialized at (b, s, vocab): the unembed + CE
    is computed in checkpointed seq chunks of cfg.loss_chunk positions,
    bounding the transient at (b, chunk, vocab)."""
    x, aux = _hidden_states(params, cfg, tokens, prefix_embed)
    if prefix_embed is not None:
        x = x[:, prefix_embed.shape[1]:, :]
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]

    def chunk_loss(xc, lc):
        logits = unembed_logits(xc, table, cfg)
        logits = softcap(logits, cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return torch.sum(lse - picked), torch.sum(torch.square(lse))

    b, s, _ = x.shape
    chunk = cfg.loss_chunk
    if chunk <= 0 or s % chunk != 0 or s <= chunk:
        ce_sum, z_sum = chunk_loss(x, labels)
    else:
        body = _remat(chunk_loss, "full", _records(x, table))
        ce_sum = z_sum = torch.zeros((), dtype=torch.float32,
                                     device=x.device)
        for c0 in range(0, s, chunk):
            ce, zz = body(x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
            ce_sum, z_sum = ce_sum + ce, z_sum + zz
    n_tok = b * s
    ce = ce_sum / n_tok
    zl = z_loss * z_sum / n_tok
    return ce + zl + aux, {"ce": ce, "z_loss": zl, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    group_caches: tuple      # per pattern position: stacked (G, ...) caches
    rem_caches: tuple        # per remainder layer
    pos: torch.Tensor        # (b,) int32 absolute position per lane


def _cache_for(cfg, kind: str, batch: int, max_len: int,
               device: Optional[torch.device], spec: bool = False):
    """A fresh cache of ``kind`` on ``device``; with ``spec`` (``device``
    then meta), its meta-tensor stand-in."""
    if kind in ("attn", "local_attn"):
        window = cfg.window if kind == "local_attn" else 0
        if spec:
            if cfg.kv_cache_dtype == "int8":
                return kv_cache_q_specs(cfg, batch, max_len, window=window)
            return kv_cache_specs(cfg, batch, max_len, window=window)
        init = (init_kv_cache_q if cfg.kv_cache_dtype == "int8"
                else init_kv_cache)
        return init(cfg, batch, max_len, window=window, device=device)
    # the recurrent states allocate on ``device`` as given: meta for a spec
    if kind == "mlstm":
        return init_mlstm_state(cfg, batch, device=device)
    if kind == "slstm":
        return init_slstm_state(cfg, batch, device=device)
    if kind == "rglru":
        return init_rglru_state(cfg, batch, device=device)
    raise KeyError(kind)


def init_decode_state(cfg, batch: int, max_len: int, *,
                      device=None, spec: bool = False) -> DecodeState:
    """Fresh decode caches on ``device`` (the card unless ``"cpu"``); with
    ``spec``, meta tensors of their shapes and dtypes (no allocation)."""
    dev = torch.device("meta") if spec else resolve_device(device)
    g, pattern, remainder = _group_split(cfg)
    group_caches = tuple(
        tree_map(lambda *a: torch.stack(a),
                  *[_cache_for(cfg, kind, batch, max_len, dev, spec)
                    for _ in range(g)])
        for kind in pattern) if g > 0 else ()
    rem = tuple(_cache_for(cfg, kind, batch, max_len, dev, spec)
                for kind in remainder)
    return DecodeState(group_caches=group_caches, rem_caches=rem,
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=dev))


def _cache_axes_for(cfg, kind: str):
    if kind in ("attn", "local_attn"):
        if cfg.kv_cache_dtype == "int8":
            return KVCacheQ(
                k=Ax("batch", "seq_cache", "kv_heads", "head_dim"),
                v=Ax("batch", "seq_cache", "kv_heads", "head_dim"),
                k_scale=Ax("batch", "seq_cache", "kv_heads"),
                v_scale=Ax("batch", "seq_cache", "kv_heads"),
                pos=Ax())
        return KVCache(k=Ax("batch", "seq_cache", "kv_heads", "head_dim"),
                       v=Ax("batch", "seq_cache", "kv_heads", "head_dim"),
                       pos=Ax())
    if kind == "mlstm":
        return MLSTMState(c=Ax("batch", "heads", None, None),
                          n=Ax("batch", "heads", None), m=Ax("batch", "heads"))
    if kind == "slstm":
        return SLSTMState(c=Ax("batch", None), n=Ax("batch", None),
                          h=Ax("batch", None), m=Ax("batch", None))
    if kind == "rglru":
        return RGLRUState(h=Ax("batch", "lru"), conv=Ax("batch", None, "lru"))
    raise KeyError(kind)


def decode_state_axes(cfg) -> DecodeState:
    """Logical axes tree matching init_decode_state (for shardings)."""
    g, pattern, remainder = _group_split(cfg)
    group_caches = tuple(
        tree_map(lambda a: Ax("stack", *a.names), _cache_axes_for(cfg, kind))
        for kind in pattern)
    rem = tuple(_cache_axes_for(cfg, kind) for kind in remainder)
    return DecodeState(group_caches=group_caches, rem_caches=rem,
                       pos=Ax("batch"))


def decode_step(params, cfg, state: DecodeState, tokens):
    """tokens (b, 1) -> (logits (b, 1, v), state).  The caches and ``pos``
    of ``state`` are advanced in place; the same state is returned."""
    compute = dtype_of(cfg.compute_dtype)
    x = embed_tokens(params["embed"], tokens, compute)
    # per-lane rope phase: (b, 1, hd/2)
    sin, cos = rope_tables(state.pos[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
    for kind, layer, gi, pi in _layers(params, cfg):
        if gi >= 0:
            cache = tree_map(lambda c: c[gi], state.group_caches[pi])
        else:
            cache = state.rem_caches[pi]
        x, _ = block_decode(layer, cfg, kind, x, sin, cos, cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = softcap(unembed_logits(x, table, cfg), cfg.logit_softcap)
    state.pos.add_(1)
    return logits, state
