"""Training and serving step functions.  Port of ``src/repro/train/steps.py``.

`make_train_step` builds the full step: loss -> grads (with optional
microbatch gradient accumulation over a DLS-planned split) -> clip -> AdamW
-> in-place update.  `make_serve_step` is the single-token decode step
against a full cache.

Where the reference runs its microbatches under ``lax.scan``, the port runs
a Python loop that accumulates fp32 gradients, and where the reference's
jitted step donates the parameter and optimizer buffers, the port updates
them in place.
"""

from __future__ import annotations

from typing import Union

import torch

from ..core.schedule import ScheduleSpec, resolve
from ..models import decode_step, loss_fn
from ..optim.adamw import AdamWState, OptimizerConfig, adamw_update
from ..random import categorical
from ..sharding import is_dtensor, shard_as
from ..tree import tree_leaves, tree_unflatten


def _grads(params, tokens, labels, prefix, cfg):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; a leaf that
    the loss does not reach gets a zero gradient, as under JAX."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, cfg, tokens, labels, prefix)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _microbatch(x, i: int, n_mb: int):
    """Microbatch ``i`` of ``n_mb`` along the batch dim: rows
    [i mb, (i + 1) mb).  Under a mesh a batch-sharded DTensor gives rows
    [i m, (i + 1) m) of every shard (m its rows / n_mb): the same examples
    over the step, and no gather of the batch."""
    from_shards = False
    if is_dtensor(x):
        from torch.distributed.tensor import Shard
        from_shards = any(p == Shard(0) for p in x.placements)
    if from_shards:
        from torch.distributed.tensor.experimental import local_map
        pl = list(x.placements)
        return local_map(
            lambda t: t[i * (t.shape[0] // n_mb):(i + 1) * (t.shape[0] // n_mb)],
            out_placements=pl, in_placements=(pl,),
            device_mesh=x.device_mesh)(x)
    mb = x.shape[0] // n_mb
    return x[i * mb:(i + 1) * mb]


def make_train_step(cfg, opt_cfg: OptimizerConfig,
                    num_microbatches: int = 1,
                    schedule: Union[ScheduleSpec, str, None] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  batch: {'tokens': (B, S), 'labels': (B, S)[, 'prefix_embed']}
    as tensors on the parameters' device; ``params`` and the state's
    moments are updated in place.

    With num_microbatches > 1, the global batch is split on the batch axis
    and fp32 gradients are accumulated over the microbatches — the in-step
    half of the DLS microbatch planner (the host half re-plans the split
    between steps from measured times; see balance/accum.py).

    ``schedule`` is the OMP_SCHEDULE idiom for accumulation: a
    ScheduleSpec/string whose chunk_param is the *microbatch size* in
    examples (``"ss,8"`` == 8-example microbatches; the batch size must be
    divisible by it).  Overrides ``num_microbatches`` when given; resolves
    $LB_SCHEDULE via "runtime".
    """
    spec = resolve(schedule) if schedule is not None else None

    def train_step(params, opt_state: AdamWState, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        prefix = batch.get("prefix_embed")
        n_mb = num_microbatches
        b = tokens.shape[0]
        if spec is not None:
            mb_size = min(spec.chunk_param, b)
            if b % mb_size:
                raise ValueError(
                    f"batch {b} not divisible by microbatch size {mb_size} "
                    f"from schedule {spec}")
            n_mb = b // mb_size
        if n_mb <= 1:
            loss, metrics, grads = _grads(params, tokens, labels, prefix,
                                          cfg)
        else:
            if b % n_mb:
                raise ValueError(f"batch {b} not divisible into {n_mb} "
                                 "microbatches")
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
            for i in range(n_mb):
                l_i, _, g_i = _grads(
                    params, _microbatch(tokens, i, n_mb),
                    _microbatch(labels, i, n_mb),
                    None if prefix is None else _microbatch(prefix, i, n_mb),
                    cfg)
                for acc, g in zip(grads, g_i):
                    acc.add_(g)
                loss = loss + l_i
                del g_i
            grads = [g / n_mb for g in grads]
            loss = loss / n_mb
            metrics = {}
        grads = tree_unflatten(params, grads)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, params)
        out = {"loss": loss, **metrics, **opt_metrics}
        return new_params, new_opt, out

    return train_step


def make_prefill_step(cfg):
    """Forward-only prefill returning last-position logits (b, v)."""
    from ..models import forward

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _aux = forward(params, cfg, batch["tokens"],
                               batch.get("prefix_embed"))
        # under a mesh a sequence shard moves to the vocab first (an
        # all-to-all), so the last position is a local slice
        return shard_as(logits, "batch", None, "vocab")[:, -1, :]

    return prefill_step


def make_serve_step(cfg, sample: bool = False, temperature: float = 1.0):
    """One decode step: (params, state, tokens (b,1), rng) ->
    (next_tokens (b,1), state).  ``sample`` draws with
    ``repro_torch.random.categorical`` from the key ``rng`` (the reference's
    key data), as the reference draws with ``jax.random``; greedy decoding
    takes no key."""

    @torch.no_grad()
    def serve_step(params, state, tokens, rng=None):
        logits, new_state = decode_step(params, cfg, state, tokens)
        # under a mesh the vocab is gathered before the pick (DTensor's
        # argmax over a vocab shard fails on a three-axis mesh)
        logits = shard_as(logits[:, -1, :], "batch", None)
        if sample:
            nxt = categorical(rng, logits / temperature, axis=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None].to(torch.int32), new_state

    return serve_step
