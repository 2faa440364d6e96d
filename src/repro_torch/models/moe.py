"""Top-k Mixture-of-Experts.  Port of ``src/repro/models/moe.py``.

Experts are the workers, tokens the loop iterations, and the router's
per-expert load is the load-imbalance problem the paper's techniques
address (``balance/moe.py`` plans tiles from it).

Dispatch implementations:
  * 'dense'  — every expert runs on every token, gate-combined, over chunks
    of ``expert_chunk`` experts (a Python loop where the reference has
    ``lax.scan``).  The baseline: E / top_k times the needed work.
  * 'ragged' — group-local sort dispatch: each token group sorts its
    (token, k) slots by expert, keeps the first ``cap`` of every expert and
    gathers them into expert rows.  The three expert matmuls (wi, wg, wo)
    go through ``kernels/grouped_matmul/ops.grouped_matmul``, one call
    each over all groups: on a CUDA tensor it launches ``gmm``
    (``csrc/gmm.cu``) with one CTA per SM over the identity tile order, and
    an unsupported dtype or shape raises there; on a CPU tensor it
    computes the same products with ``grouped_matmul_tiles_plain``.  Under
    autograd each product is an ``_ExpertMatmul`` whose backward computes
    dX with ``gmm_dx`` and dW with ``gmm_dw`` on the card, and with
    ``grouped_matmul_bwd_plain`` on the CPU.  The combine gathers each token's ``top_k`` contributions and sums them in
    k order (no atomics), so one input gives one output on every run.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from ..kernels.grouped_matmul.grouped_matmul import (KERNEL_BLOCK_ROWS,
                                                     grouped_matmul_bwd)
from ..kernels.grouped_matmul.ops import grouped_matmul
from ..sharding import Ax, shard_as
from .layers import activate, dense_init, use_weight


def init_moe(gen: torch.Generator, cfg):
    d = cfg.d_model
    e = cfg.moe
    ff = e.d_ff
    gated = cfg.activation in ("swiglu", "geglu")

    def expert_stack(a, b):
        w = torch.empty((e.num_experts, a, b), dtype=torch.float32,
                        device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_((1.0 / a) ** 0.5)

    params = {
        "router": dense_init(gen, d, e.num_experts, "embed", "experts")[0],
        "router_bias": torch.zeros((e.num_experts,), dtype=torch.float32,
                                   device=gen.device),
        "wi": expert_stack(d, ff),
        "wo": expert_stack(ff, d),
    }
    axes = {
        "router": Ax("embed", "experts"),
        "router_bias": Ax("experts"),
        "wi": Ax("experts", "embed", "expert_mlp"),
        "wo": Ax("experts", "expert_mlp", "embed"),
    }
    if gated:
        params["wg"] = expert_stack(d, ff)
        axes["wg"] = Ax("experts", "embed", "expert_mlp")
    return params, axes


@contextlib.contextmanager
def _full_fp32_matmul():
    """fp32 matmuls without TF32 inside the block, whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _route(params, cfg, x):
    """Router: top-k expert ids + renormalized weights + aux loss + load.

    The adaptive bias (balance/moe.py) shifts *selection* only — combine
    weights come from the unbiased probabilities.  All in fp32.
    """
    e = cfg.moe
    with _full_fp32_matmul():
        logits = torch.einsum("bsd,de->bse", x.float(),
                              params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    biased = probs + params["router_bias"][None, None, :]
    idx = torch.topk(biased, e.top_k, dim=-1).indices          # (b, s, k)
    gate = torch.gather(probs, -1, idx)                         # (b, s, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    sel = F.one_hot(idx, e.num_experts).float().sum(2)
    frac_tokens = sel.mean((0, 1)) / e.top_k
    frac_probs = probs.mean((0, 1))
    aux = e.num_experts * torch.sum(frac_tokens * frac_probs) \
        * e.router_aux_loss
    load = sel.sum((0, 1))  # tokens per expert (AWF balancer telemetry)
    return idx, gate, aux, load


def _capacity(cfg, tokens: int) -> int:
    e = cfg.moe
    c = int(e.capacity_factor * tokens * e.top_k / e.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


def moe_dense(params, cfg, x, expert_chunk: int = 16):
    """Baseline: run every expert on every token, combine by gates, over
    chunks of ``expert_chunk`` experts."""
    b, s, d = x.shape
    e = cfg.moe
    idx, gate, aux, load = _route(params, cfg, x)
    dt = x.dtype
    ec = min(expert_chunk, e.num_experts)
    assert e.num_experts % ec == 0
    # per-token weight for every expert (0 if not selected); the k ids of a
    # token are distinct, so a plain scatter sets each once
    wfull = torch.zeros((b, s, e.num_experts), dtype=torch.float32,
                        device=x.device).scatter_(-1, idx, gate)
    acc = torch.zeros((b, s, d), dtype=dt, device=x.device)
    for c0 in range(0, e.num_experts, ec):
        sl = slice(c0, c0 + ec)
        h_lin = torch.einsum("bsd,edf->bsef", x, params["wi"][sl].to(dt))
        if "wg" in params:
            h = activate(torch.einsum("bsd,edf->bsef", x,
                                      params["wg"][sl].to(dt)),
                         h_lin, cfg.activation)
        else:
            h = activate(h_lin, None, cfg.activation)
        y = torch.einsum("bsef,efd->bsed", h, params["wo"][sl].to(dt))
        acc = acc + torch.einsum("bsed,bse->bsd", y, wfull[..., sl].to(dt))
    return shard_as(acc, "batch", "seq", "embed_act"), aux, load


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _ExpertMatmul(torch.autograd.Function):
    """xe (E, R, d) @ w (E, d, f) -> (E, R, f) through ``grouped_matmul``;
    the backward computes only the gradients asked for, dX and dW, with
    ``grouped_matmul_bwd`` (the kernels on the card, the plain version on
    the CPU)."""

    @staticmethod
    def forward(ctx, xe, w, sched_p):
        ctx.save_for_backward(xe, w)
        ctx.sched_p = sched_p
        return grouped_matmul(xe, w, block_rows=KERNEL_BLOCK_ROWS,
                              sched_p=sched_p)

    @staticmethod
    def backward(ctx, dy):
        xe, w = ctx.saved_tensors
        dx, dw = grouped_matmul_bwd(
            xe, w, dy, need_dx=ctx.needs_input_grad[0],
            need_dw=ctx.needs_input_grad[1], sched_p=ctx.sched_p)
        return dx, dw, None


def _expert_matmul(xe, w):
    """xe (E, R, d) expert rows @ w (E, d, f) -> (E, R, f), R a multiple of
    the kernel's row tile.  On a CUDA tensor ``gmm`` runs with one CTA per
    SM over the identity order, forward and backward; a CPU tensor takes
    the plain versions."""
    sched_p = _sm_count(xe.device.index) if xe.is_cuda else 8
    return _ExpertMatmul.apply(xe, w, sched_p)


def moe_ragged(params, cfg, x):
    """Group-local sort-based dispatch onto the grouped matmul.

    Tokens are split into ``moe_groups`` groups along the batch dim; each
    group sorts its (token, k) slots by expert (stable) and keeps the first
    ``cap`` slots of every expert, as the reference does.  Expert e's rows
    are the groups' capacity buffers side by side, ``G * cap`` rows padded
    with zero rows to a multiple of the kernel's 128-row tile; the padding
    changes no output.
    """
    b, s, d = x.shape
    e = cfg.moe
    n_e, k = e.num_experts, e.top_k
    dev = x.device
    idx, gate, aux, load = _route(params, cfg, x)
    groups = min(cfg.moe_groups, b)
    while b % groups != 0:
        groups //= 2
    ng = (b // groups) * s                    # tokens per group
    nk = ng * k                               # slots per group
    cap = _capacity(cfg, ng)
    r_pad = -(-groups * cap // KERNEL_BLOCK_ROWS) * KERNEL_BLOCK_ROWS

    es, order = torch.sort(idx.reshape(groups, nk), dim=1, stable=True)
    starts = torch.searchsorted(
        es, torch.arange(n_e, device=dev).expand(groups, n_e).contiguous(),
        side="left")                                         # (G, E)
    slot = torch.arange(nk, device=dev)[None]
    rank = slot - torch.gather(starts, 1, es)
    keep = rank < cap
    gidx = torch.arange(groups, device=dev)[:, None]
    # slot tables.  Expert row of each sorted slot it keeps; `zero` is one
    # past the last row and stands for a zero row.
    zero = n_e * r_pad
    row = es * r_pad + gidx * cap + rank
    # the token each expert row reads (a zero row where none): a dropped
    # slot writes past the table, to an entry of its own
    src = torch.full((zero + groups * nk,), groups * ng, dtype=torch.long,
                     device=dev)
    src.scatter_(0, torch.where(keep, row, zero + gidx * nk + slot).reshape(-1),
                 (gidx * ng + order // k).reshape(-1))
    # the expert row each (token, k) reads its output back from
    back = torch.empty_like(order).scatter_(1, order,
                                            torch.where(keep, row, zero))

    x_ext = torch.cat([x.reshape(groups * ng, d), x.new_zeros((1, d))])
    xe = x_ext[src[:zero].reshape(n_e, r_pad)]               # (E, R, d)
    xe = shard_as(xe, "experts", None, "embed_act")
    dt = x.dtype
    wi = use_weight(params["wi"].to(dt), cfg, "experts", None, "expert_mlp")
    h_lin = _expert_matmul(xe, wi)
    if "wg" in params:
        wg = use_weight(params["wg"].to(dt), cfg, "experts", None,
                        "expert_mlp")
        h = activate(_expert_matmul(xe, wg), h_lin, cfg.activation)
    else:
        h = activate(h_lin, None, cfg.activation)
    wo = use_weight(params["wo"].to(dt), cfg, "experts", "expert_mlp", None)
    ye = _expert_matmul(h, wo)
    ye = torch.cat([ye.reshape(zero, d), ye.new_zeros((1, d))])
    # combine: token t's k contributions, gathered and summed in k order
    back = back.reshape(groups * ng, k)
    w = gate.reshape(groups * ng, k).to(dt)
    y = ye[back[:, 0]] * w[:, :1]
    for kk in range(1, k):
        y = y + ye[back[:, kk]] * w[:, kk:kk + 1]
    y = y.reshape(b, s, d)
    return shard_as(y, "batch", "seq", "embed_act"), aux, load


def moe(params, cfg, x):
    if cfg.moe.dispatch == "ragged":
        return moe_ragged(params, cfg, x)
    return moe_dense(params, cfg, x)
