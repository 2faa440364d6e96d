"""Shared model building blocks: initializers, norms, embeddings, RoPE,
activations.  Port of ``src/repro/models/layers.py``.

Every module is an (init, apply) pair of plain functions on tensors; init
takes a ``torch.Generator`` (its device is where the parameters are made)
and returns (params, axes), axes mirroring params with ``sharding.Ax``
leaves naming the logical axes of each tensor.  A generator cannot give
``jax.random``'s bits, so the tests hand both packages the same parameters
through ``repro_torch.convert``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..sharding import Ax, is_dtensor, shard_as

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, in_ax: str,
               out_ax: str, dtype=torch.float32,
               scale: Optional[float] = None):
    """Kernel (in, out) with truncated-normal fan-in scaling: a standard
    normal truncated to [-2, 2], times ``scale`` (default in_dim^-1/2)."""
    scale = (1.0 / in_dim) ** 0.5 if scale is None else scale
    w = torch.empty((in_dim, out_dim), dtype=dtype, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(scale), Ax(in_ax, out_ax)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32):
    w = torch.randn((vocab, d), generator=gen, dtype=dtype, device=gen.device)
    return w.mul_(0.02), Ax("vocab", "embed")


def norm_init(d: int, dtype=torch.float32, device=None):
    return torch.ones((d,), dtype=dtype, device=device), Ax("embed")


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    # under a mesh the scale's FSDP shard is gathered, not the activations
    scale = shard_as(scale, None)
    return (out * scale.float()).to(dt)


def activate(x_gate: torch.Tensor, x_lin: Optional[torch.Tensor],
             kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(x_gate) * x_lin
    if kind == "geglu":
        return F.gelu(x_gate, approximate="tanh") * x_lin
    if kind == "gelu":
        return F.gelu(x_gate, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                dtype=torch.float32):
    """positions (..., s) -> sin/cos tables (..., s, head_dim/2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.sin(ang).to(dtype), torch.cos(ang).to(dtype)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, hd); sin/cos: (b, s, hd/2) or (s, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.ndim == 2:
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    else:
        sin = sin[:, :, None, :]
        cos = cos[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def use_weight(w: torch.Tensor, cfg, *logical) -> torch.Tensor:
    """Weight as consumed by a matmul; with cfg.gather_weights, constrained
    to its logical layout (the identity on one GPU).  Under a mesh every
    weight is so constrained: its FSDP (``embed``) shard is gathered at
    use, as the reference's compiler does, where DTensor's own choice
    gathers the activations instead (internvl2-1b's prefill_32k then
    held 721 GB a device)."""
    if getattr(cfg, "gather_weights", False) or is_dtensor(w):
        return shard_as(w, *logical)
    return w


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    if is_dtensor(embed):
        x = _embed_sharded(embed, tokens)
    else:
        x = embed[tokens.long()]
    return shard_as(x.to(compute_dtype), "batch", "seq", "embed_act")


def _embed_sharded(embed, tokens):
    """The lookup on DTensors (``local_map``): each rank gathers its vocab
    shard's rows whole (the ``embed`` dim over ``data``) and looks up the
    tokens of its batch shard that fall in its rows, zeros elsewhere, a
    partial sum over the vocab shards (DTensor's own strategy for the
    indexing takes no token batch sharded over two mesh axes)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = embed.device_mesh
    vocab = [p == Shard(0) for p in embed.placements]
    table_pl = [Shard(0) if v else Replicate() for v in vocab]
    tok_pl = [Replicate() if v else p for v, p in zip(vocab, tokens.placements)]
    out_pl = [Partial() if v else p for v, p in zip(vocab, tok_pl)]
    grad_pl = [Shard(0) if v else Partial() if p == Shard(0) else Replicate()
               for v, p in zip(vocab, tok_pl)]
    rows, offset = compute_local_shape_and_global_offset(embed.shape, mesh,
                                                         table_pl)

    def lookup(table, tok):
        idx = tok.long() - offset[0]
        here = (idx >= 0) & (idx < rows[0])
        out = table[idx.clamp(0, rows[0] - 1)]
        return out * here[..., None].to(out.dtype)

    return local_map(lookup, out_placements=out_pl,
                     in_placements=(table_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(embed, tokens)


def unembed_logits(x: torch.Tensor, table: torch.Tensor,
                   cfg=None) -> torch.Tensor:
    """x (b, s, d) @ table.T (v, d) -> (b, s, v) in float32 for the loss."""
    t = table.float()
    if cfg is not None:
        t = use_weight(t, cfg, "vocab", None)
    logits = x.float() @ t.T
    return shard_as(logits, "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# temporal conv (recurrent blocks)
# ---------------------------------------------------------------------------


def conv1d_init(gen: torch.Generator, width: int, channels: int,
                dtype=torch.float32):
    w = torch.randn((width, channels), generator=gen, dtype=dtype,
                    device=gen.device)
    return w.mul_((1.0 / width) ** 0.5), Ax("conv", "lru")


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x (b, s, c), w (width, c).

    Training/prefill: state=None, zero left-pad, returns (y, last (width-1)
    inputs as new state).  Decode: x (b, 1, c) with state (b, width-1, c).
    The taps are summed in the reference's order, tap 0 first.
    """
    width = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[:1] + (width - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[i][None, None, :].to(x.dtype)
            for i in range(width))
    new_state = xp[:, xp.shape[1] - (width - 1):, :]
    return y, new_state


def dtype_of(name: str) -> torch.dtype:
    """``cfg.compute_dtype`` / ``param_dtype`` string -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
