"""AdamW + gradient clipping + warmup-cosine schedule.  Port of
``src/repro/optim/adamw.py``.

The optimizer state mirrors the parameter tree.  The arithmetic is the
reference's, in fp32: moments in fp32, ``b1 ** step`` in fp32, the global
norm's clip scale applied to every gradient.  Where the reference's jitted
step donates the old buffers, the port updates parameters and moments in
place under ``torch.no_grad()``: ``adamw_update`` returns the trees it was
given, advanced.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..sharding import Ax
from ..tree import tree_leaves, tree_map

__all__ = ["OptimizerConfig", "AdamWState", "adamw_init", "adamw_state_axes",
           "lr_schedule", "global_norm", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: object           # tree like params
    nu: object


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(torch.zeros_like, params),
                      nu=tree_map(torch.zeros_like, params))


def adamw_state_axes(param_axes):
    """Axes tree for the optimizer state (mirrors params)."""
    return AdamWState(step=Ax(), mu=param_axes, nu=param_axes)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), fp32."""
    s = step.to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, the leaves
    summed in the reference's order."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state: AdamWState, params):
    """Returns (params, state, metrics): ``params`` and the state's moments
    updated in place, the step advanced."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=sf.device), sf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        del g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (upd + cfg.weight_decay * pf))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics
