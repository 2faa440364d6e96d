"""Public wrapper: expert-capacity layout (E, C, d) -> DLS-planned tiles ->
grouped matmul -> (E, C, f).

The (E, C) capacity buffer is cut into row tiles of ``block_rows``, the
tile list is ordered by the DLS planner (see
``repro_torch.balance.moe.plan_tiles``), and each tile is multiplied by
its expert's weights.

Passing ``schedule=`` (any registry technique / ScheduleSpec) plans the
tile order inside this wrapper from the measured per-expert loads
(``expert_rows``, host telemetry).  On the card the plan's live shares go
one to each of ``sched_p`` CTAs and the dead tiles are dealt round-robin
after them; without a plan the order is split into ``sched_p`` contiguous
spans.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ...balance.moe import plan_tiles
from ...core.torch_sched import worker_bounds
from ...device import check_device
from .grouped_matmul import gmm_cuda, grouped_matmul_tiles, span_bounds


def _host_order(tile_order) -> np.ndarray:
    if isinstance(tile_order, torch.Tensor):
        tile_order = tile_order.cpu().numpy()
    return np.asarray(tile_order, np.int64)


def _grouped_matmul_core(xe, weights, tile_order, *, block_rows: int,
                         sched_p: int = 8, plan=None):
    e, c, d = xe.shape
    f = weights.shape[2]
    assert c % block_rows == 0, (c, block_rows)
    tiles_per_e = c // block_rows
    t = e * tiles_per_e
    x_tiles = xe.reshape(t, block_rows, d)
    tile_expert = torch.arange(t, dtype=torch.int32,
                               device=xe.device) // tiles_per_e
    if xe.device.type == "cuda":
        # the gather into plan order and the inverse permutation are folded
        # into the kernel's indexing: step i reads and writes tile order[i]
        order = (np.arange(t, dtype=np.int32) if tile_order is None
                 else _host_order(tile_order).astype(np.int32))
        if plan is None:
            bounds, n_span = span_bounds(t, sched_p), t
        else:
            bounds, n_span = worker_bounds(plan.step_worker, plan.p), plan.n
        out = gmm_cuda(x_tiles.contiguous(), weights, tile_expert, order,
                       bounds, n_span)
        return out.reshape(e, c, f)
    if tile_order is not None:
        tile_order = torch.from_numpy(_host_order(tile_order))
        x_tiles = x_tiles[tile_order]
        tile_expert = tile_expert[tile_order]
    out = grouped_matmul_tiles(x_tiles, weights, tile_expert)
    if tile_order is not None:
        inv = torch.empty_like(tile_order)
        inv[tile_order] = torch.arange(t, dtype=tile_order.dtype)
        out = out[inv]
    return out.reshape(e, c, f)


def grouped_matmul(xe, weights, tile_order=None, *, block_rows: int = 128,
                   schedule: Union[str, object, None] = None,
                   expert_rows: Optional[Sequence[int]] = None,
                   sched_p: int = 8, recorder=None):
    """xe: (E, C, d) capacity layout; weights (E, d, f) -> (E, C, f).

    tile_order: optional (T,) permutation of tile ids from the DLS
    planner (T = E * C / block_rows); identity if omitted.

    schedule: plan the tile order here instead — DLS chunking of the
    live tiles given ``expert_rows`` (host array of live rows per expert;
    defaults to full capacity, i.e. uniform cost).  ``sched_p`` is the
    planner's worker count (the kernel's CTA count on the card) and
    ``recorder`` (LoopRecorder) receives the plan's kernel telemetry.
    Mutually exclusive with an explicit ``tile_order``.
    """
    check_device(xe, weights)
    plan = None
    if schedule is not None:
        if tile_order is not None:
            raise ValueError("pass either tile_order or schedule, not both")
        e, c, _ = xe.shape
        rows = (np.full(e, c, np.int64) if expert_rows is None
                else np.asarray(expert_rows, np.int64))
        tile_order, plan = plan_tiles(rows, block_rows, p=sched_p,
                                      technique=schedule, capacity_rows=c,
                                      return_plan=True)
        if recorder is not None:
            recorder.add(plan.to_record(
                "grouped_matmul",
                instance=recorder.next_instance("grouped_matmul")))
    return _grouped_matmul_core(xe, weights, tile_order,
                                block_rows=block_rows, sched_p=sched_p,
                                plan=plan)
