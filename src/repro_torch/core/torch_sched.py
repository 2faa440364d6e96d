"""Torch chunk calculus and kernel tile scheduling — the port of
``src/repro/core/jax_sched.py``.

Two parts:

  * the closed forms, as eager torch code on int64 / float64 tensors on an
    explicit device (the card unless the caller passes ``"cpu"``):
    ``plan_chunks`` -> padded int32 ``(sizes, starts, count)`` for the
    deterministic techniques (static / ss / gss / tss / fac2 / fac / mfac /
    wf2 / tap / fsc), bound on the port's registry with ``bind_graph_form``
    as in the reference; ``max_chunks_bound``; ``awf_update``; ``AFState``
    with ``af_init`` / ``af_update`` / ``af_chunk``; ``balanced_assignment``.
    The reference's ``lax.while_loop`` and ``lax.scan`` are Python loops.
    Its float forms run in float32 without x64 (``_tap_next``,
    ``_fac_batch_chunk``, ``_plan_tss``'s index, wf2's weights); the port
    computes them in float64, the precision of the host techniques, whose
    plans both are held to.  ``_ceil_div`` stays exact integer division.
  * the host kernel-tile planner, kept in NumPy and byte-faithful:
    ``KernelTilePlan``, ``plan_tiles_for_kernel``, ``plan_tiles_cached``
    and the cache counters.  The LPT pre-sort stays
    ``np.argsort(-costs, kind="stable")``; torch's sort does not promise
    the same order among equal costs.

On Hopper a plan is run by a persistent kernel with ``p`` CTAs: CTA ``w``
walks ``plan.shares()[w]`` in order, so ``worker_cost``, ``cov`` and
``percent_imbalance`` describe what the card ran.  ``worker_bounds`` gives
the per-CTA start/end offsets into ``order`` that the kernels take.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from .metrics import LoopInstanceRecord, cov, percent_imbalance
from .planner import plan_schedule
from .schedule import REGISTRY, ScheduleSpec, bind_graph_form, resolve

__all__ = [
    "PlanContext",
    "plan_chunks",
    "max_chunks_bound",
    "awf_update",
    "AFState",
    "af_init",
    "af_update",
    "af_chunk",
    "balanced_assignment",
    "KernelTilePlan",
    "plan_tiles_for_kernel",
    "plan_tiles_cached",
    "kernel_plan_cache_stats",
    "kernel_plan_cache_clear",
    "worker_bounds",
]

_I64, _F64 = torch.int64, torch.float64


def max_chunks_bound(technique: str | ScheduleSpec, n: int, p: int,
                     chunk_param: Optional[int] = None) -> int:
    """Static upper bound on the number of chunks (for padding).

    An explicit ``chunk_param`` overrides the spec's; with a bare name
    and no chunk_param, 1 (the portfolio default) is assumed.
    """
    if isinstance(technique, ScheduleSpec):
        t = technique.technique
        cp = chunk_param if chunk_param is not None else technique.chunk_param
    else:
        t = technique.lower().replace("-", "_")
        cp = 1 if chunk_param is None else chunk_param
    cp = max(1, cp)
    if t == "static":
        return p if cp <= 1 else math.ceil(n / cp)
    if t in ("ss", "fsc"):
        # fsc degenerates to fixed chunks >= cp; worst case cp itself
        return math.ceil(n / cp)
    if t in REGISTRY:
        gf = REGISTRY[t].graph
        if gf is not None and gf.max_chunks is not None:
            return int(gf.max_chunks(n, p, cp))
    # decreasing-chunk techniques: chunk >= max(cp, 1) each round; the
    # geometric families need ~P*log2(N/(P*cp)) + P rounds; be generous.
    geo = (p + 1) * (int(math.log2(max(n, 2))) + 2)
    return int(min(math.ceil(n / cp), max(geo, 4 * p)))


def _ceil_div(a: torch.Tensor, b: int) -> torch.Tensor:
    """Exact integer ceil-division (the reference's guard against a
    reciprocal multiply that is off by 1 ULP around exact multiples)."""
    a = a.to(_I64)
    return (a + (b - 1)) // b


def _gss_next(remaining, p, cp):
    return torch.clamp_min(_ceil_div(remaining, p), cp)


def _fac2_next(remaining, p, cp, k):
    # batch chunk recomputed every P requests; within batch it is frozen.
    # Closed form: batch j chunk = ceil(R_j / 2P), R_{j+1} = R_j - P*c_j.
    del k
    return torch.clamp_min(_ceil_div(remaining, 2 * p), cp)


def _tap_next(remaining, p, cp, v):
    t = remaining / p
    c = t + v * v / 2.0 - v * torch.sqrt(2.0 * t + v * v / 4.0)
    return torch.clamp_min(torch.ceil(c).to(_I64), cp)


def _fac_batch_chunk(remaining, p, cp, cov):
    b = (p / (2.0 * torch.sqrt(remaining))) * cov
    x = 1.0 + b * b + b * torch.sqrt(b * b + 2.0)
    c = torch.ceil(remaining / (x * p)).to(_I64)
    return torch.clamp_min(c, cp)


@dataclasses.dataclass(frozen=True)
class PlanContext:
    """Everything a registered graph form may need to compute chunks.

    Passed to ``GraphForm.builder(ctx)`` and
    ``GraphForm.next_size(ctx, rem_total, rem_batch, i)`` — plugin
    techniques binding a graph form via
    :func:`repro_torch.core.schedule.bind_graph_form` receive the same
    context.  ``rem_total`` and ``rem_batch`` are 0-d float64 tensors on
    ``device``, ``i`` is the chunk index; a form returns a 0-d int64
    tensor.  ``v`` is ``alpha * sigma / mu`` in the host TAP's operation
    order.
    """

    n: int
    p: int
    cp: int                 # chunk_param
    mc: int                 # max chunks (padding bound)
    mu: float = 1.0
    sigma: float = 0.0
    h: float = 1e-6
    alpha: float = 1.3
    cov: float = 0.0        # sigma / mu
    v: float = 0.0          # alpha * cov (TAP)
    w: Any = None           # (P,) normalized worker weights (wf2), float64
    max_chunks: Optional[int] = None  # caller's explicit padding request
    device: Any = None      # torch.device every tensor lives on


def _prefix_plan(sizes: torch.Tensor, n: int):
    """(sizes,) -> clipped (sizes, starts, count) triplet, int32.

    Enforces the ``plan_chunks`` contract both ways: sizes are clipped so
    they never overrun ``n``, and any deficit left by an under-sized
    ``max_chunks`` is folded into the last slot so the plan always
    partitions ``[0, n)`` exactly (sum(sizes) == n).
    """
    sizes = _clip_to_n(sizes.to(_I64), n)
    sizes[-1] += n - sizes.sum()
    starts = torch.cumsum(sizes, 0) - sizes
    count = (sizes > 0).sum()
    return (sizes.to(torch.int32), starts.to(torch.int32),
            count.to(torch.int32))


# -- direct array builders ---------------------------------------------------


def _plan_static(ctx: PlanContext):
    if ctx.cp > 1:
        sizes_np = np.full(ctx.mc, ctx.cp, np.int64)
    else:
        base, rem = divmod(ctx.n, ctx.p)
        nat = [base + (1 if i < rem else 0) for i in range(ctx.p)][:ctx.mc]
        sizes_np = np.array(nat + [0] * (ctx.mc - len(nat)), np.int64)
    return _prefix_plan(torch.from_numpy(sizes_np).to(ctx.device), ctx.n)


def _plan_ss(ctx: PlanContext):
    # fixed chunks of cp; _prefix_plan clips the natural tail and folds any
    # under-sized-max_chunks remainder into the last slot
    return _prefix_plan(
        torch.full((ctx.mc,), ctx.cp, dtype=_I64, device=ctx.device), ctx.n)


def _plan_fsc(ctx: PlanContext):
    logp = math.log(max(ctx.p, 2))
    if ctx.sigma <= 0:
        c = max(1, math.ceil(ctx.n / ctx.p))
    else:
        c = max(1, math.ceil(((math.sqrt(2.0) * ctx.n * ctx.h)
                              / (ctx.sigma * ctx.p * math.sqrt(logp)))
                             ** (2.0 / 3.0)))
    c = max(c, ctx.cp)
    return plan_chunks("ss", ctx.n, ctx.p, chunk_param=c,
                       max_chunks=ctx.max_chunks or math.ceil(ctx.n / c),
                       device=ctx.device)


def _plan_tss(ctx: PlanContext):
    first = max(1, math.ceil(ctx.n / (2 * ctx.p)))
    last = min(max(1, ctx.cp), first)
    steps = max(1, math.ceil(2 * ctx.n / (first + last)))
    delta = (first - last) / (steps - 1) if steps > 1 else 0.0
    idx = torch.arange(ctx.mc, dtype=_F64, device=ctx.device)
    raw = torch.clamp_min(torch.ceil(first - idx * delta).to(_I64), last)
    return _prefix_plan(raw, ctx.n)


# -- per-request next-size forms (consumed by the generic request loop) ------


def _next_gss(ctx, rem_total, rem_batch, i):
    del rem_batch, i
    return _gss_next(torch.clamp_min(rem_total, 1.0), ctx.p, ctx.cp)


def _next_tap(ctx, rem_total, rem_batch, i):
    del rem_batch, i
    return _tap_next(torch.clamp_min(rem_total, 1.0), ctx.p, ctx.cp, ctx.v)


def _next_fac(ctx, rem_total, rem_batch, i):
    del rem_total, i
    return _fac_batch_chunk(torch.clamp_min(rem_batch, 1.0), ctx.p, ctx.cp,
                            ctx.cov)


def _next_fac2(ctx, rem_total, rem_batch, i):
    del rem_total, i
    return _fac2_next(torch.clamp_min(rem_batch, 1.0), ctx.p, ctx.cp, None)


def _next_wf2(ctx, rem_total, rem_batch, i):
    base = _fac2_next(torch.clamp_min(rem_batch, 1.0), ctx.p, ctx.cp, None)
    wkr = i % ctx.p
    return torch.clamp_min(torch.ceil(ctx.w[wkr] * base).to(_I64), ctx.cp)


# torch_sched's dispatch table IS the registry: each closed form is bound
# to its technique entry, next to the host reference class.
bind_graph_form("static", builder=_plan_static)
bind_graph_form("ss", builder=_plan_ss)
bind_graph_form("fsc", builder=_plan_fsc)
bind_graph_form("tss", builder=_plan_tss)
bind_graph_form("gss", next_size=_next_gss)
bind_graph_form("tap", next_size=_next_tap)
bind_graph_form("fac", next_size=_next_fac, batched=True)
bind_graph_form("mfac", next_size=_next_fac, batched=True)
bind_graph_form("fac2", next_size=_next_fac2, batched=True)
bind_graph_form("wf2", next_size=_next_wf2, batched=True)

def plan_chunks(
    technique: str | ScheduleSpec,
    n: int,
    p: int,
    chunk_param: Optional[int] = None,
    *,
    mu: float = 1.0,
    sigma: float = 0.0,
    h: float = 1e-6,
    alpha: float = 1.3,
    weights=None,
    max_chunks: Optional[int] = None,
    device=None,
):
    """Compute the full chunk schedule on ``device`` (the card unless the
    caller passes ``"cpu"``).

    Returns (sizes[int32, max_chunks], starts[int32, max_chunks],
    count[int32]) tensors on ``device``.  Entries past ``count`` are zero.
    For weighted techniques (wf2) the i-th chunk belongs to worker i % p.

    ``max_chunks`` contract: it is a *padding bound*, not a truncation —
    the returned sizes always partition ``[0, n)`` exactly
    (``sum(sizes) == n`` and ``count <= max_chunks``).  When a
    caller-supplied ``max_chunks`` is smaller than the technique's natural
    chunk count, the remainder is folded into the final slot (the last
    chunk absorbs the tail).  An explicit ``max_chunks < 1`` raises
    ``ValueError``.

    Dispatch is registry-driven: any technique whose entry carries a
    :class:`~repro_torch.core.schedule.GraphForm` (including user-registered
    plugins) is plannable here; techniques without one raise ``KeyError``.
    The per-request forms run as a loop of gated requests that reads
    ``scheduled < n`` back before every request (a host sync each).
    """
    spec = resolve(technique, chunk_param=chunk_param)
    t, cp = spec.technique, spec.chunk_param
    graph = REGISTRY[t].graph
    if graph is None:
        raise KeyError(
            f"plan_chunks: unsupported technique {t!r}; in-graph forms exist "
            f"for {sorted(REGISTRY.graph_names(plannable=True))} (bind one "
            f"with repro_torch.core.schedule.bind_graph_form)")
    if graph.builder is None and graph.next_size is None:
        # campaign (step-only) form: the chunk sequence depends on
        # measured telemetry, so there is no up-front schedule to plan
        raise KeyError(
            f"plan_chunks: technique {t!r} has a campaign (step-only) graph "
            f"form — its chunk sequence depends on runtime measurements; "
            f"run it with repro_torch.core.graph_sim.simulate_batch_graph; "
            f"plannable techniques: "
            f"{sorted(REGISTRY.graph_names(plannable=True))}")

    if max_chunks is not None and max_chunks < 1:
        raise ValueError(f"max_chunks must be >= 1, got {max_chunks}")
    dev = resolve_device(device)
    mc = int(max_chunks or max_chunks_bound(t, n, p, cp))
    cov_ = 0.0 if mu <= 0 else sigma / mu
    if weights is None:
        w = torch.ones(p, dtype=_F64, device=dev)
    else:
        w = torch.as_tensor(np.asarray(weights, np.float64), device=dev)
        w = w * (p / w.sum())
    v = float(alpha) * max(float(sigma), 0.0) / max(float(mu), 1e-30)
    ctx = PlanContext(n=n, p=p, cp=cp, mc=mc, mu=mu, sigma=sigma, h=h,
                      alpha=alpha, cov=cov_, v=v, w=w,
                      max_chunks=max_chunks, device=dev)

    if graph.builder is not None:
        return graph.builder(ctx)

    sizes = torch.zeros(mc, dtype=_I64, device=dev)
    scheduled = torch.zeros((), dtype=_I64, device=dev)
    batch_rem = torch.full((), n, dtype=_I64, device=dev)
    count = torch.zeros((), dtype=_I64, device=dev)
    for i in range(mc):
        if i and not bool(scheduled < n):
            break
        act = scheduled < n
        left = torch.clamp_min(n - scheduled, 0)
        c = graph.next_size(ctx, left.to(_F64), batch_rem.to(_F64), i)
        c = torch.minimum(torch.clamp_min(c, 1), left)
        if i == mc - 1:
            # final slot: fold whatever remains so the plan always sums to
            # n even when max_chunks under-estimates the round count
            c = torch.clamp_min(left, 1)
        c = torch.where(act, c, 0)
        sizes[i] = c
        scheduled = scheduled + c
        count = count + act.to(_I64)
        if graph.batched and (i + 1) % p == 0:
            batch_rem = torch.where(act, torch.clamp_min(n - scheduled, 0),
                                    batch_rem)
    # slots past count keep start 0, as the reference's loop leaves them
    starts = torch.where(torch.arange(mc, device=dev) < count,
                         torch.cumsum(sizes, 0) - sizes, 0)
    return (sizes.to(torch.int32), starts.to(torch.int32),
            count.to(torch.int32))


def _clip_to_n(sizes: torch.Tensor, n: int) -> torch.Tensor:
    """Clip a tentative size sequence so cumulative sum == n."""
    prev = torch.cumsum(sizes, 0) - sizes
    return torch.minimum(sizes, torch.clamp_min(n - prev, 0))


# ---------------------------------------------------------------------------
# Adaptive family — between-step updates
# ---------------------------------------------------------------------------


def awf_update(wap_num: torch.Tensor, wap_den: torch.Tensor, k,
               times: torch.Tensor, sizes: torch.Tensor,
               recency: bool = True):
    """One AWF adaptation point: fold measured (time, size) per worker.

    Returns (weights, wap_num, wap_den, k+1) on the inputs' device.
    weights sum to P.  Matches techniques._AWFBase._adapt
    (recency-weighted pi averaging).
    """
    p = times.shape[0]
    k1 = torch.as_tensor(k, device=times.device) + 1
    pi = times / torch.clamp_min(sizes, 1e-30)
    mask = sizes > 0
    kw = k1.to(times.dtype) if recency else torch.ones_like(times[0])
    wap_num = wap_num + torch.where(mask, kw * pi, 0.0)
    wap_den = wap_den + torch.where(mask, kw, 0.0)
    wap = wap_num / torch.clamp_min(wap_den, 1e-30)
    inv = torch.where(wap_den > 0, 1.0 / torch.clamp_min(wap, 1e-30), 1.0)
    weights = p * inv / torch.sum(inv)
    return weights, wap_num, wap_den, k1


class AFState(NamedTuple):
    cnt: torch.Tensor   # (P,)
    mean: torch.Tensor  # (P,) per-iteration mean time
    m2: torch.Tensor    # (P,) Welford M2


def af_init(p: int, device=None) -> AFState:
    """Zero float32 AF statistics (as in the reference) on ``device``
    (the card unless ``"cpu"``)."""
    z = torch.zeros(p, dtype=torch.float32, device=resolve_device(device))
    return AFState(cnt=z, mean=z, m2=z)


def af_update(s: AFState, worker_times: torch.Tensor,
              worker_sizes: torch.Tensor) -> AFState:
    """Size-weighted Welford update of per-worker per-iteration time stats
    (vectorized over workers; a chunk of k iterations contributes k
    observations of its mean — matches techniques.AF.complete_chunk;
    size==0 -> no-op)."""
    valid = worker_sizes > 0
    k = worker_sizes.to(s.cnt.dtype)
    per_iter = worker_times / torch.clamp_min(worker_sizes, 1e-30)
    cnt = s.cnt + torch.where(valid, k, 0.0)
    d = per_iter - s.mean
    mean = torch.where(valid, s.mean + d * k / torch.clamp_min(cnt, 1.0),
                       s.mean)
    m2 = torch.where(valid, s.m2 + k * d * (per_iter - mean), s.m2)
    return AFState(cnt=cnt, mean=mean, m2=m2)


def af_chunk(s: AFState, remaining) -> torch.Tensor:
    """AF chunk size per worker given current stats: the Banicescu-Liu rule
    c_p = (D + 2TR - sqrt(D^2 + 4DTR)) / (2 mu_p)."""
    mu = torch.clamp_min(s.mean, 1e-30)
    var = torch.where(s.cnt > 1, s.m2 / torch.clamp_min(s.cnt - 1.0, 1.0),
                      0.0)
    d = torch.sum(var / mu)
    t = 1.0 / torch.sum(1.0 / mu)
    r = torch.as_tensor(remaining, device=mu.device).to(mu.dtype)
    c = (d + 2.0 * t * r - torch.sqrt(d * d + 4.0 * d * t * r)) / (2.0 * mu)
    # GSS envelope guard, matching techniques.AF._chunk_size
    c = torch.minimum(c, torch.ceil(r / mu.shape[0]))
    return torch.clamp_min(torch.ceil(c).to(torch.int32), 1)


# ---------------------------------------------------------------------------
# DLS-planned balanced assignment of ragged work (framework entry point)
# ---------------------------------------------------------------------------


def balanced_assignment(costs: torch.Tensor, p: int,
                        weights=None) -> torch.Tensor:
    """Assign N ragged work items to P workers, greedy-LPT weighted by DLS
    (AWF/WF) worker weights.  Returns int32 worker id per item, on the
    device of ``costs``.

    O(N * P); the reference's ``lax.scan`` is a Python loop over the items
    in decreasing-cost order.  Ties go to the lowest worker (argmin).
    """
    n = costs.shape[0]
    dev = costs.device
    w = (torch.ones(p, dtype=torch.float32, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=dev))
    w = w * (p / torch.sum(w))
    order = torch.argsort(-costs, stable=True)
    by_cost = costs[order]
    loads = torch.zeros(p, dtype=costs.dtype, device=dev)
    assign_sorted = torch.empty(n, dtype=torch.int64, device=dev)
    wdiv = torch.clamp_min(w, 1e-6)
    for j in range(n):
        item = by_cost[j:j + 1]
        # effective finishing time if assigned: (load + cost) / weight;
        # index_add_ keeps the target on the device (no host sync)
        tgt = torch.argmin((loads + item) / wdiv).view(1)
        loads.index_add_(0, tgt, item)
        assign_sorted[j:j + 1] = tgt
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    out[order] = assign_sorted.to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# Kernel tile scheduling — DLS chunk calculus applied to kernel tiles
# ---------------------------------------------------------------------------


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
