"""MoE expert load balancing via the paper's adaptive techniques.

NumPy copy of ``src/repro/balance/moe.py`` for the PyTorch port; the tile
planner underneath is ``repro_torch.core.torch_sched``.

Two host-side mechanisms, both driven by `repro.core` chunk calculus:

1. `MoEBalancer` — AWF reformulated for experts.  Experts are workers,
   tokens are loop iterations; the measured per-expert load (router
   telemetry) plays the role of AWF's measured chunk times.  The balancer
   maintains AWF weights and converts them into a *router bias* adjusting
   expert selection between steps (auxiliary-loss-free balancing; cadence
   equals AWF-B's batch boundary == training step).

2. `plan_tiles` — DLS-planned tile order for the grouped-matmul kernel:
   expert row-tiles are interleaved by FAC2 chunking over the per-expert
   backlog so that a sequential split of the tile list across cores gives
   near-equal work (the paper's chunk calculus applied to MXU tiles).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from ..core.torch_sched import KernelTilePlan, plan_tiles_for_kernel
from ..core.metrics import LoopRecorder
from ..core.schedule import ScheduleSpec, resolve

__all__ = ["MoEBalancer", "plan_tiles"]


@dataclasses.dataclass
class MoEBalancer:
    """AWF-style adaptive expert weighting -> router bias.

    call `update(load)` after each step with measured tokens-per-expert;
    read `bias` (numpy, (E,)) to feed params['router_bias'].

    ``schedule`` names the adaptive technique whose weighting rule the
    balancer applies (must be adaptive per the registry); its
    ``adapt_every`` is the cadence — telemetry accumulates every step but
    weights/bias refresh only at every k-th update (AWF's adaptation-point
    generalized to the router).
    """

    num_experts: int
    bias_strength: float = 1e-2
    recency: bool = True
    schedule: Union[ScheduleSpec, str] = "awf"
    #: technique the balancer hands down to the grouped-matmul tile
    #: planner (``plan_kernel_tiles``) — the kernel-level half of the
    #: balancing loop; any registry technique.
    kernel_schedule: Union[ScheduleSpec, str] = "fac2"

    def __post_init__(self):
        self.spec = resolve(self.schedule, default="awf")
        if not self.spec.meta.adaptive:
            raise ValueError(
                f"MoEBalancer needs an adaptive technique, got "
                f"{self.spec.technique!r} (adaptive=False)")
        self.kernel_spec = resolve(self.kernel_schedule, default="fac2")
        self.kernel_recorder = LoopRecorder()
        self._wap_num = np.zeros(self.num_experts)
        self._wap_den = np.zeros(self.num_experts)
        self._k = 0
        self.weights = np.ones(self.num_experts)
        self.bias = np.zeros(self.num_experts)

    def update(self, load: np.ndarray) -> np.ndarray:
        """load: measured tokens routed to each expert this step."""
        load = np.asarray(load, dtype=np.float64)
        total = load.sum()
        if total <= 0:
            return self.bias
        # AWF pi: 'time per unit of work'; an overloaded expert has high
        # effective time-per-token (it is the straggler of the step)
        pi = load / (total / self.num_experts)  # relative load, mean 1
        self._k += 1
        kw = float(self._k) if self.recency else 1.0
        self._wap_num += kw * pi
        self._wap_den += kw
        if self._k % self.spec.adapt_every:
            return self.bias  # between adaptation points: accumulate only
        wap = np.maximum(self._wap_num / self._wap_den, 1e-9)
        inv = 1.0 / wap
        self.weights = self.num_experts * inv / inv.sum()
        # cumulative (integral) bias: keep shifting selection toward
        # underloaded experts (weights > 1) until loads equalize — the
        # aux-loss-free balancing rule expressed through AWF weights
        self.bias = self.bias + self.bias_strength * (self.weights - 1.0)
        return self.bias

    def plan_kernel_tiles(self, expert_rows: np.ndarray, block_rows: int,
                          p: int = 8, *,
                          capacity_rows: Optional[int] = None,
                          worker_weights: Optional[Sequence[float]] = None,
                          ) -> tuple[np.ndarray, KernelTilePlan]:
        """Pass the balancer's spec down to the grouped-matmul kernel.

        Plans the tile order for the measured per-expert loads with
        ``kernel_schedule`` and records the plan's telemetry
        (LoopInstanceRecord) into ``kernel_recorder`` — the kernel-level
        counterpart of ``update``'s router telemetry.  ``worker_weights``
        (per-core speeds, (p,)) bias the chunk assignment like AWF worker
        weights; expert skew is already carried by ``expert_rows``.
        """
        order, plan = plan_tiles(
            expert_rows, block_rows, p=p, technique=self.kernel_spec,
            capacity_rows=capacity_rows, weights=worker_weights,
            return_plan=True)
        self.kernel_recorder.add(plan.to_record(
            "grouped_matmul",
            instance=self.kernel_recorder.next_instance("grouped_matmul")))
        return order, plan


def plan_tiles(expert_rows: np.ndarray, block_rows: int, p: int = 8,
               technique: Union[ScheduleSpec, str] = "fac2", *,
               capacity_rows: Optional[int] = None,
               weights: Optional[Sequence[float]] = None,
               assign: str = "greedy",
               overhead_per_chunk: float = 0.0,
               return_plan: bool = False):
    """Order expert row-tiles so a P-way sequential split balances work.

    expert_rows: (E,) number of *live* rows per expert (ragged loads).
    Returns a permutation of tile ids for the capacity layout
    (tile id = e * tiles_per_expert + j), live tiles first, ordered by the
    DLS chunk calculus over the ragged backlog
    (:func:`repro_torch.core.torch_sched.plan_tiles_for_kernel` — each live tile
    costs its live rows; the last tile of an expert may be partial), dead
    (all-padding) tiles last.

    ``capacity_rows`` fixes the capacity layout's rows-per-expert (the C
    of the (E, C, d) buffer); when omitted it is inferred from
    ``expert_rows.max()``.  ``weights``/``assign``/``overhead_per_chunk``
    pass through to the kernel tile planner.  With ``return_plan=True``
    the :class:`~repro_torch.core.torch_sched.KernelTilePlan` (cost-model
    telemetry over the *live* tiles) is returned alongside the order.
    """
    expert_rows = np.asarray(expert_rows)
    e = expert_rows.shape[0]
    cap_src = capacity_rows if capacity_rows is not None else (
        int(expert_rows.max()) if expert_rows.size else 0)
    cap_tiles = int(np.ceil(cap_src / block_rows)) if e else 0

    tile_ids: list[int] = []
    tile_cost: list[int] = []
    for ei in range(e):
        rows = int(min(expert_rows[ei], cap_src))
        for j in range(int(np.ceil(rows / block_rows))):
            tile_ids.append(ei * cap_tiles + j)
            tile_cost.append(min(block_rows, rows - j * block_rows))

    plan = plan_tiles_for_kernel(tile_cost, p=p, technique=technique,
                                 weights=weights, assign=assign,
                                 overhead_per_chunk=overhead_per_chunk)
    ids = np.asarray(tile_ids, np.int64)
    live_ids = ids[plan.order] if ids.size else ids
    dead = sorted(set(range(e * cap_tiles)) - set(live_ids.tolist()))
    order = np.asarray(list(live_ids) + dead, dtype=np.int32)
    return (order, plan) if return_plan else order
