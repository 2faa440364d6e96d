"""Kernel tile scheduling — the DLS chunk calculus applied to kernel tiles.

Host part of ``src/repro/core/jax_sched.py`` (its lines 480-727) for the
PyTorch port, kept in NumPy and byte-faithful: ``KernelTilePlan``,
``plan_tiles_for_kernel``, ``plan_tiles_cached`` and the cache counters.
The LPT pre-sort stays ``np.argsort(-costs, kind="stable")``; torch's sort
does not promise the same order among equal costs.

On Hopper a plan is run by a persistent kernel with ``p`` CTAs: CTA ``w``
walks ``plan.shares()[w]`` in order, so ``worker_cost``, ``cov`` and
``percent_imbalance`` describe what the card ran.  ``worker_bounds`` gives
the per-CTA start/end offsets into ``order`` that the kernels take.

The reference's jnp closed forms (``plan_chunks``, ``awf_update``,
``af_*``, ``balanced_assignment``, ``max_chunks_bound``) are not ported
yet (ROADMAP.md, port queue item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .metrics import LoopInstanceRecord, cov, percent_imbalance
from .planner import plan_schedule
from .schedule import ScheduleSpec, resolve

__all__ = [
    "KernelTilePlan",
    "plan_tiles_for_kernel",
    "plan_tiles_cached",
    "kernel_plan_cache_stats",
    "kernel_plan_cache_clear",
    "worker_bounds",
]


@dataclasses.dataclass(frozen=True)
class KernelTilePlan:
    """A DLS-planned tile-to-worker assignment for a kernel launch.

    ``order`` is laid out so that the per-worker spans are exactly the
    per-worker tile lists the chunk calculus produced — worker ``w`` owns
    the steps where ``step_worker == w`` (a contiguous run, workers in
    ascending order).  On the card, worker ``w`` is CTA ``w`` of a
    persistent kernel.

    ``worker_cost`` is the cost model's estimate of each worker's span
    (compute cost of its tiles + per-chunk scheduling overhead);
    ``to_record()`` turns it into a :class:`LoopInstanceRecord` so kernel
    launches feed the same cov / percent_imbalance metrics as simulated
    loops.
    """

    spec: ScheduleSpec
    p: int
    n: int                    # live tiles planned
    order: np.ndarray         # (n,) int32: tile id per step
    step_worker: np.ndarray   # (n,) int32: worker owning each step
    step_cost: np.ndarray     # (n,) float64: estimated cost per step
    worker_cost: np.ndarray   # (p,) float64: estimated cost per worker span
    n_chunks: int             # scheduling rounds (o_sr)
    sched_time: float         # total per-chunk overhead across workers

    @property
    def t_par(self) -> float:
        """Cost-model parallel time: the slowest worker's span."""
        return float(self.worker_cost.max(initial=0.0))

    @property
    def cov(self) -> float:
        return cov(self.worker_cost)

    @property
    def percent_imbalance(self) -> float:
        return percent_imbalance(self.worker_cost, self.t_par)

    def shares(self) -> list[np.ndarray]:
        """Per-worker contiguous spans of ``order`` (what each CTA runs)."""
        return [self.order[self.step_worker == w] for w in range(self.p)]

    def to_record(self, loop: str, instance: int = 0) -> LoopInstanceRecord:
        """Kernel-level telemetry in the KMP_TIME_LOOPS unit of record."""
        return LoopInstanceRecord(
            loop=loop, technique=self.spec.technique, instance=instance,
            p=self.p, n=self.n, chunk_param=self.spec.chunk_param,
            t_par=self.t_par,
            thread_times=self.worker_cost.copy(),
            thread_finish=self.worker_cost.copy(),
            n_chunks=self.n_chunks, sched_time=self.sched_time)


def worker_bounds(step_worker: np.ndarray, p: int) -> np.ndarray:
    """(p + 1,) int32 offsets: worker ``w`` owns steps ``[b[w], b[w+1])``.

    Valid because ``order`` holds each worker's span contiguously, in
    ascending worker order.
    """
    counts = np.bincount(np.asarray(step_worker, np.int64), minlength=p)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def plan_tiles_for_kernel(
    costs: Sequence[float],
    p: int = 8,
    technique: Union[ScheduleSpec, str, None] = "fac2",
    *,
    weights: Optional[Sequence[float]] = None,
    assign: str = "greedy",
    overhead_per_chunk: float = 0.0,
    cost_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> KernelTilePlan:
    """Plan the tile order of a kernel launch with DLS chunking.

    ``costs`` gives the estimated execution cost of each kernel tile (live
    rows for grouped matmul, live KV columns for a flash-attention q
    block).  Tiles are sorted by decreasing cost (the LPT preconditioning
    the factoring family assumes), the sorted list is chunked by the
    technique's calculus (``plan_schedule`` over ``n = len(costs)``
    iterations), and each chunk is assigned to one of ``p`` workers:

      * ``assign="greedy"`` (default) — cost-weighted least-finish-time,
        optionally scaled by per-worker ``weights``;
      * ``assign="round_robin"`` — chunk i to worker i % p, the canonical
        SPMD order (matches ``plan_schedule``'s request order exactly).

    ``overhead_per_chunk`` is the per-scheduling-round overhead in cost
    units, scaled by the technique's relative chunk-calculation cost
    ``o_cs``.  ``cost_fn`` maps raw costs to effective costs before
    planning.

    Returns a :class:`KernelTilePlan`; ``order`` is a permutation of
    ``range(len(costs))`` — callers append dead/padding tiles themselves
    (see ``repro_torch.balance.moe.plan_tiles``).
    """
    if assign not in ("greedy", "round_robin"):
        raise ValueError(
            f"assign must be 'greedy' or 'round_robin', got {assign!r}")
    spec = resolve(technique, default="fac2")
    costs = np.asarray(costs, dtype=np.float64)
    if cost_fn is not None:
        costs = np.asarray(cost_fn(costs), dtype=np.float64)
    if costs.ndim != 1:
        raise ValueError(f"costs must be 1-D, got shape {costs.shape}")
    n = costs.shape[0]
    if n == 0:
        z = np.zeros(0, np.int32)
        return KernelTilePlan(spec=spec, p=p, n=0, order=z, step_worker=z,
                              step_cost=np.zeros(0), n_chunks=0,
                              worker_cost=np.zeros(p), sched_time=0.0)
    if weights is None:
        w = np.ones(p, dtype=np.float64)
    else:
        w = np.asarray(weights, dtype=np.float64)
        if w.shape != (p,):
            raise ValueError(f"weights must have shape ({p},), got {w.shape}")
        if not np.isfinite(w).all() or w.sum() <= 0:
            raise ValueError(
                f"weights must be finite with a positive sum, got {w} — "
                f"an all-zero AWF warm-up should pass weights=None instead")
        w = np.maximum(w * (p / w.sum()), 1e-6)

    by_cost = np.argsort(-costs, kind="stable")       # tile ids, LPT order
    plan = plan_schedule(spec, n=n, p=p)
    o_cs = spec.meta.o_cs * overhead_per_chunk

    # chunk -> worker assignment
    loads = np.zeros(p, dtype=np.float64)
    wtiles: list[list[np.ndarray]] = [[] for _ in range(p)]
    csum = np.concatenate([[0.0], np.cumsum(costs[by_cost])])
    for c in plan.chunks:
        chunk_cost = csum[c.start + c.size] - csum[c.start] + o_cs
        if assign == "round_robin":
            tgt = c.worker
        else:
            tgt = int(np.argmin((loads + chunk_cost) / w))
        loads[tgt] += chunk_cost
        wtiles[tgt].append(by_cost[c.start:c.start + c.size])

    order = np.concatenate(
        [np.concatenate(t) if t else np.zeros(0, np.int64) for t in wtiles]
    ).astype(np.int32)
    step_worker = np.concatenate(
        [np.full(sum(map(len, t)), wkr, np.int32)
         for wkr, t in enumerate(wtiles)])
    return KernelTilePlan(
        spec=spec, p=p, n=n, order=order, step_worker=step_worker,
        step_cost=costs[order], worker_cost=loads,
        n_chunks=plan.n_chunks, sched_time=o_cs * plan.n_chunks)


# ---------------------------------------------------------------------------
# Serving plan cache — memoized KernelTilePlan lookups
# ---------------------------------------------------------------------------

#: (cost-signature, p, spec, assign, overhead, weights-bucket) -> plan
_PLAN_CACHE: dict[tuple, KernelTilePlan] = {}
_PLAN_CACHE_MAX = 1024
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0, "bypass": 0}


def _weights_key(weights, p: int, bucket: float):
    """Quantize weights into relative buckets so near-identical AWF
    weight vectors share one cached plan."""
    if weights is None:
        return None
    w = np.asarray(weights, dtype=np.float64)
    scale = w.sum() / max(p, 1)
    if not np.isfinite(scale) or scale <= 0:
        return ("raw", w.tobytes())
    q = np.round(w / scale / max(bucket, 1e-9)).astype(np.int64)
    return (float(bucket), q.tobytes())


def plan_tiles_cached(
    costs: Sequence[float],
    p: int = 8,
    technique: Union[ScheduleSpec, str, None] = "fac2",
    *,
    weights: Optional[Sequence[float]] = None,
    assign: str = "greedy",
    overhead_per_chunk: float = 0.0,
    cost_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    weights_bucket: float = 0.05,
) -> KernelTilePlan:
    """Memoized :func:`plan_tiles_for_kernel`, keyed on

      (cost signature, p, resolved spec, assign, overhead_per_chunk,
       weights bucket)

    where the weights bucket quantizes normalized weights to multiples of
    ``weights_bucket``.  A ``cost_fn`` is opaque, so those calls bypass
    the cache.  Returns a *shared* plan — treat its arrays as read-only.
    The cache holds at most 1024 plans (evicting oldest-inserted).
    """
    if cost_fn is not None:
        _PLAN_CACHE_STATS["bypass"] += 1
        return plan_tiles_for_kernel(
            costs, p=p, technique=technique, weights=weights,
            assign=assign, overhead_per_chunk=overhead_per_chunk,
            cost_fn=cost_fn)
    spec = resolve(technique, default="fac2")
    c = np.asarray(costs, dtype=np.float64)
    key = (c.tobytes(), c.shape, p, spec, assign,
           float(overhead_per_chunk),
           _weights_key(weights, p, weights_bucket))
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE_STATS["hits"] += 1
        return plan
    _PLAN_CACHE_STATS["misses"] += 1
    plan = plan_tiles_for_kernel(
        c, p=p, technique=spec, weights=weights, assign=assign,
        overhead_per_chunk=overhead_per_chunk)
    if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    _PLAN_CACHE[key] = plan
    return plan


def kernel_plan_cache_stats() -> dict:
    """Copy of the plan-cache counters (hits/misses/bypass + size)."""
    return dict(_PLAN_CACHE_STATS, size=len(_PLAN_CACHE))


def kernel_plan_cache_clear() -> None:
    _PLAN_CACHE.clear()
    _PLAN_CACHE_STATS.update(hits=0, misses=0, bypass=0)
