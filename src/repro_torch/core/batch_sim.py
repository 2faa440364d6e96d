"""Config-parallel batch simulation engine — the campaign accelerator
(NumPy copy of ``src/repro/core/batch_sim.py`` for the PyTorch port).

The discrete-event simulator (`core/simulator.py`) steps one heapq event
at a time, which makes it the *oracle* but also the bottleneck of every
sweep-shaped scenario: the paper's performance-analysis campaign (every
technique x workload x thread-count x chunk-param pair), the follow-up
algorithm-selection work that needs thousands of cheap schedule
evaluations, and the property tests that grind through the registry.

``simulate_batch`` runs a whole grid of configurations in one pass:

  1. **Plan precompute.**  For every technique whose chunk sequence is a
     pure function of (technique, n, p, params, seed) — i.e. neither
     ``adaptive`` nor ``worker_dependent`` in its
     :class:`~repro_torch.core.schedule.TechniqueSpec` — the full (sizes,
     starts, batches) schedule is materialized up front: closed NumPy
     forms for the fixed-chunk family (static/ss/fsc) and tight scalar
     recurrences for gss/tap (the techniques whose chunk counts explode
     on fine-granularity loops), with the host reference state machines
     draining the rest (factoring family and plugins — a few hundred
     chunks each).  These are the same chunk values `torch_sched`'s graph
     forms compute in-graph; the host path is used here because a device
     round trip per grid point would dwarf the simulation itself.
  2. **Vectorized recurrence.**  The shared-queue dynamics reduce to:
     chunk k goes to the worker with the least (ready_time, tiebreak);
     its clock advances by the chunk's scheduling + execution cost.
     That recurrence is stepped once per chunk index with NumPy across
     *all* live lanes (a lane = one (config, timestep) instance), so the
     per-event Python cost is amortized over the whole grid.  Overheads,
     ccNUMA locality, heterogeneous speeds, deterministic perturbation,
     and the FAC mutex critical section are modelled bit-identically to
     the event loop.

Adaptive / worker-dependent techniques (AWF*/AF/mAF/BOLD, WF2) cannot be
pre-planned — their chunk sizes depend on who requests and what was
measured — but they *can* be vectorized: the event oracle feeds each
chunk's measurement back in request order, so the whole adaptive
calculus is a deterministic per-chunk recurrence.  The **lockstep band**
(:func:`_run_lockstep_band`) advances all lanes of one technique chunk-
round by chunk-round, with the per-lane weight/timing state held as
dense ``(L,)`` / ``(L, p)`` arrays and the technique-specific updates
supplied by the vectorized ``step_batch`` forms registered alongside the
GraphForms in `core/schedule.py` (see
:class:`repro_torch.core.techniques.BatchTechnique`).  Only prebuilt
``Technique`` instances, rng-taking ``perturb(ts, worker, rng)``
callbacks, and plugins without a ``step_batch`` form fall back to the
event-driven oracle, keeping ``simulate_batch`` exact across the entire
registry.  (A 2-argument ``perturb(ts, worker)`` is assumed to be a pure
function — the same contract `simulate`'s docstring states — since
impurity is not detectable from the signature.)  Agreement (t_par,
per-thread finish times, chunk counts) is property-tested in
tests/test_batch_sim.py; the campaign speedup is tracked by
benchmarks/batch_bench.py (non-adaptive grid) and
benchmarks/adaptive_bench.py (adaptive grid).
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import warnings
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .metrics import LoopInstanceRecord, LoopRecorder
from .schedule import ScheduleSpec, resolve
from .simulator import (
    EXACT_PROFILE,
    OverheadModel,
    ProfileModel,
    SimResult,
    _technique_kwargs,
    simulate,
)
from .stealing import StealGrant
from .techniques import ChunkGrant, Technique
from .workloads import Workload

__all__ = ["BatchConfig", "batch_grid", "simulate_batch"]


@dataclasses.dataclass(frozen=True, eq=False)
class BatchConfig:
    """One grid point: everything ``simulate`` takes, as data.

    ``overhead``/``profile`` override the batch-wide models when set, so
    heterogeneous grids (e.g. the paper's EXACT vs NOISY profiling
    regimes) can run in a single ``simulate_batch`` call.
    """

    technique: Union[ScheduleSpec, str, Technique]
    workload: Workload
    p: int
    chunk_param: Optional[int] = None
    timesteps: int = 1
    speeds: Optional[Sequence[float]] = None
    numa_penalty: float = 0.0
    chunk_cold_cost: float = 0.0
    weights: Optional[Sequence[float]] = None
    perturb: Optional[Callable] = None
    seed: int = 0
    overhead: Optional[OverheadModel] = None
    profile: Optional[ProfileModel] = None


def batch_grid(
    techniques: Sequence[Union[ScheduleSpec, str]],
    workloads: Sequence[Workload],
    ps: Sequence[int] = (20,),
    chunk_params: Sequence[Optional[int]] = (None,),
    seeds: Sequence[int] = (0,),
    **common,
) -> list[BatchConfig]:
    """Cartesian grid helper over all five axes.

    Order is workload-major: workload varies slowest, then technique, p,
    chunk_param, and seed fastest — configs sharing a workload stay
    adjacent, which is also the order the campaign drivers iterate."""
    return [
        BatchConfig(technique=t, workload=w, p=p, chunk_param=cp, seed=s,
                    **common)
        for w in workloads
        for t in techniques
        for p in ps
        for cp in chunk_params
        for s in seeds
    ]


# ---------------------------------------------------------------------------
# Plan precompute
# ---------------------------------------------------------------------------


class _Plan:
    __slots__ = ("sizes", "starts", "batches", "leader")

    def __init__(self, sizes, starts, batches):
        self.sizes = np.asarray(sizes, np.int64)
        self.starts = np.asarray(starts, np.int64)
        self.batches = np.asarray(batches, np.int64)
        # first request of each batch (the mutex critical-section leader)
        leader = np.zeros(len(self.batches), bool)
        if len(self.batches):
            _, first = np.unique(self.batches, return_index=True)
            leader[first] = True
        self.leader = leader

    def __len__(self) -> int:
        return len(self.sizes)


def _fixed_plan(n: int, c: int) -> _Plan:
    """Constant chunk c with a clipped tail; batch index == request index."""
    k = -(-n // c)
    sizes = np.full(k, c, np.int64)
    sizes[-1] = n - (k - 1) * c
    return _Plan(sizes, np.arange(k, dtype=np.int64) * c,
                 np.arange(k, dtype=np.int64))


def _plan_static(n: int, p: int, cp: int) -> _Plan:
    if cp > 1:
        return _fixed_plan(n, cp)
    base, rem = divmod(n, p)
    nat = [base + (1 if i < rem else 0) for i in range(p)]
    sizes = np.asarray([s for s in nat if s > 0], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return _Plan(sizes, starts, np.arange(len(sizes), dtype=np.int64))


def _plan_fsc(spec: ScheduleSpec, n: int, p: int, cp: int,
              kw: dict) -> _Plan:
    # FSC is one formula evaluation, then fixed chunks: reuse the
    # registered class so the calculus lives in exactly one place
    tech = spec.make(n=n, p=p, **kw)
    return _fixed_plan(n, max(tech._chunk, cp))


def _plan_gss(n: int, p: int, cp: int) -> _Plan:
    sizes = []
    rem = n
    while rem > 0:
        c = min(max(-(-rem // p), cp), rem)
        sizes.append(c)
        rem -= c
    sizes = np.asarray(sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return _Plan(sizes, starts, np.arange(len(sizes), dtype=np.int64))


def _plan_tap(n: int, p: int, cp: int, kw: dict) -> _Plan:
    # mirror TAP._init/_chunk_size exactly (same float64 operations)
    mu = max(float(kw.get("mu", 1.0)), 1e-30)
    sigma = max(float(kw.get("sigma", 0.0)), 0.0)
    v = 1.3 * sigma / mu
    sizes = []
    rem = n
    while rem > 0:
        t = rem / p
        c = t + v * v / 2.0 - v * math.sqrt(2.0 * t + v * v / 4.0)
        c = max(1, int(math.ceil(c)))
        c = min(max(c, cp), rem)
        sizes.append(c)
        rem -= c
    sizes = np.asarray(sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return _Plan(sizes, starts, np.arange(len(sizes), dtype=np.int64))


def _drain_plan(tech: Technique, instance: int) -> _Plan:
    """Drive a host reference instance through one loop instance."""
    tech.begin_instance(instance)
    sizes, starts, batches = [], [], []
    while True:
        g = tech.next_chunk(0)
        if g is None:
            break
        sizes.append(g.size)
        starts.append(g.start)
        batches.append(g.batch)
    tech.end_instance()
    return _Plan(sizes, starts, batches)


def _accepts_seed_kw(kw: dict) -> bool:
    return "seed" in kw


def _plans_for(spec: ScheduleSpec, n: int, p: int, timesteps: int,
               kw: dict, cache: dict) -> list[_Plan]:
    """One plan per timestep (a single shared plan when the technique is
    deterministic across instances — everything except the seed-consuming
    RNG techniques, whose generator state persists over time-steps).

    Deterministic techniques are cached timesteps-agnostically (one plan,
    replicated per call), so mixed-timesteps grids share it; seeded ones
    key on timesteps because each instance drains fresh RNG state."""
    t, cp = spec.technique, spec.chunk_param
    seeded = _accepts_seed_kw(kw)
    kwkey = tuple(sorted(kw.items()))
    if seeded:
        key = (t, cp, n, p, kwkey, timesteps)
        plans = cache.get(key)
        if plans is None:
            tech = spec.make(n=n, p=p, **kw)
            plans = [_drain_plan(tech, ts) for ts in range(timesteps)]
            cache[key] = plans
        return plans
    key = (t, cp, n, p, kwkey)
    plan = cache.get(key)
    if plan is None:
        if t == "static":
            plan = _plan_static(n, p, cp)
        elif t == "ss":
            plan = _fixed_plan(n, cp)
        elif t == "fsc":
            plan = _plan_fsc(spec, n, p, cp, kw)
        elif t == "gss":
            plan = _plan_gss(n, p, cp)
        elif t == "tap":
            plan = _plan_tap(n, p, cp, kw)
        else:
            plan = _drain_plan(spec.make(n=n, p=p, **kw), 0)
        cache[key] = plan
    return [plan] * timesteps


# ---------------------------------------------------------------------------
# Vectorized worker-assignment / finish-time recurrence
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Lane:
    """One (config, timestep) instance on the fast path."""

    config_idx: int
    instance: int
    cfg: BatchConfig
    spec: ScheduleSpec
    plan: _Plan
    speeds_eff: np.ndarray  # (p,) speeds * perturb(ts, w)
    overhead: OverheadModel

    @property
    def n(self) -> int:
        return self.cfg.workload.n

    @property
    def p(self) -> int:
        return self.cfg.p


def _lane_speeds(cfg: BatchConfig, ts: int) -> np.ndarray:
    p = cfg.p
    speeds = (np.ones(p) if cfg.speeds is None
              else np.asarray(cfg.speeds, float))
    if speeds.shape != (p,):
        raise ValueError(f"speeds must have shape ({p},)")
    if cfg.perturb is not None:
        # the event loop evaluates perturb per chunk; a *pure* f(ts, w)
        # makes that equivalent to one evaluation per (timestep, worker).
        # Purity of 2-arg callbacks is the caller's contract (see
        # simulate_batch) — only the 3-arg rng form is detectably
        # stateful and routed to the oracle.
        speeds = np.array([speeds[w] * cfg.perturb(ts, w) for w in range(p)])
    return speeds


def _run_lane_band(lanes: list[_Lane], mutex: bool, numa: bool,
                   record_chunks: bool):
    """Run one band of lanes, bit-identically to the event-driven oracle.

    Bands group lanes by (mutex critical section?, numa penalty?) so the
    inner loop only pays for the terms its lanes actually use.  The
    atomic-sync band (everything except FAC) steps the recurrence in
    *rounds* of up to P forced assignments per lane per numpy step
    (:func:`_run_band_rounds`); the mutex band, whose workers couple
    through the critical section, steps one chunk index at a time
    (:func:`_run_band_chunkwise`) — FAC-family chunk counts are small, so
    that path is never the bottleneck.
    """
    del record_chunks  # both paths always produce the worker log
    if mutex:
        return _run_band_chunkwise(lanes, numa=numa)
    return _run_band_rounds(lanes, numa=numa)


def _flatten_lanes(lanes: list[_Lane]):
    """Flatten a band's plans: per-lane (nch, offs) plus flat per-chunk
    (sizes, starts, base-cost) arrays.  ``base`` is the worker-independent
    execution cost (csum[start+size] - csum[start]) — the exact float64
    operands the event oracle uses, so downstream math stays bit-identical.
    """
    nch = np.asarray([len(l.plan) for l in lanes], np.int64)
    offs = np.concatenate([[0], np.cumsum(nch)[:-1]])
    sizes_flat = np.concatenate([l.plan.sizes for l in lanes])
    starts_flat = np.concatenate([l.plan.starts for l in lanes])
    base_flat = np.empty(int(nch.sum()))
    csum_cache: dict[int, np.ndarray] = {}
    for li, l in enumerate(lanes):
        w = l.cfg.workload
        csum = csum_cache.get(id(w))
        if csum is None:
            csum = np.concatenate([[0.0], np.cumsum(w.costs)])
            csum_cache[id(w)] = csum
        sl = slice(offs[li], offs[li] + nch[li])
        base_flat[sl] = (csum[starts_flat[sl] + sizes_flat[sl]]
                         - csum[starts_flat[sl]])
    return nch, offs, sizes_flat, starts_flat, base_flat


def _lane_stats(lanes, offs, nch, wlog, e_log, s_log, done_log):
    """Post-pass: fold per-chunk logs into per-worker busy/sched/finish."""
    out = []
    for li, l in enumerate(lanes):
        p = l.p
        sl = slice(offs[li], offs[li] + nch[li])
        wl = wlog[sl]
        busy = np.bincount(wl, weights=e_log[sl], minlength=p).astype(float)
        sched = np.bincount(wl, weights=s_log[sl], minlength=p).astype(float)
        finish = np.zeros(p)
        finish[wl] = done_log[sl]  # done is monotone per worker: last wins
        out.append((l, busy, sched, finish, wl))
    return out


def _run_band_rounds(lanes: list[_Lane], numa: bool):
    """Vectorized rounds for the atomic-sync band.

    The shared-queue heap process (pop least (ready, tiebreak) worker,
    push it back at ready + cost) pops non-decreasing ready times, so
    with the per-lane ready times sorted as r_1 <= ... <= r_P and the
    next chunks' completion times d_j = (r_j + s) + e_j, the first j
    assignments of a round are *forced* round-robin-in-sorted-order as
    long as r_{j+1} <= min(d_1..d_j): nothing pushed this round can
    overtake the remaining sorted prefix.  Each numpy step commits that
    maximal forced prefix (>= 1 chunk, up to P) per live lane — on the
    fixed-chunk techniques whose schedules have ~N/cp chunks (the lanes
    that dominate a campaign grid) the prefix is almost always the full
    round, cutting the Python-step count by ~P versus stepping one chunk
    index at a time.  Lanes advance independent cursors, so mixed grids
    stay dense.  Operand order matches the event loop exactly."""
    L = len(lanes)
    pmax = max(l.p for l in lanes)
    nch, offs, sizes_flat, starts_flat, base_flat = _flatten_lanes(lanes)
    total = int(nch.sum())

    ready = np.full((L, pmax), np.inf)
    tb = np.full((L, pmax), np.inf)
    speeds_mat = np.ones((L, pmax))
    pvec = np.asarray([l.p for l in lanes], np.int64)
    tb_base = np.empty(L)
    cold = np.empty(L)
    sconst = np.empty(L)
    for li, l in enumerate(lanes):
        ready[li, :l.p] = 0.0
        tb[li, :l.p] = np.arange(l.p, dtype=float)
        speeds_mat[li, :l.p] = l.speeds_eff
        tb_base[li] = float(l.n)
        cold[li] = l.cfg.chunk_cold_cost
        sconst[li] = ((l.overhead.o_dispatch
                       + l.overhead.sync_cost(l.spec.meta.sync))
                      + l.overhead.calc_cost(l.spec.meta.o_cs))
    if numa:
        pen = np.asarray([l.cfg.numa_penalty for l in lanes])
        bounds = np.zeros((L, pmax + 1), np.int64)
        for li, l in enumerate(lanes):
            bounds[li, :l.p + 1] = np.linspace(0, l.n, l.p + 1).astype(np.int64)

    wlog = np.zeros(total, np.int32)
    e_log = np.zeros(total)
    done_log = np.zeros(total)
    s_log = np.repeat(sconst, nch)

    cursor = np.zeros(L, np.int64)
    jj = np.arange(pmax)
    while True:
        act = np.nonzero(cursor < nch)[0]
        if not len(act):
            break
        r = ready[act]
        t = tb[act]
        rowsA = np.arange(len(act))[:, None]
        # batched lexsort by (ready, tiebreak): stable argsort on the
        # secondary key first, then on the reordered primary
        o1 = np.argsort(t, axis=1, kind="stable")
        o2 = np.argsort(r[rowsA, o1], axis=1, kind="stable")
        ws = o1[rowsA, o2]                          # sorted worker ids
        rs = r[rowsA, ws]                           # sorted ready times

        cidx = cursor[act, None] + jj[None, :]
        valid = (cidx < nch[act, None]) & (jj[None, :] < pvec[act, None])
        flat = offs[act, None] + np.minimum(cidx, nch[act, None] - 1)
        base = base_flat[flat]
        if numa:
            size = sizes_flat[flat]
            lo = starts_flat[flat]
            hi = lo + size
            a2 = act[:, None]
            local = np.maximum(
                np.minimum(hi, bounds[a2, ws + 1])
                - np.maximum(lo, bounds[a2, ws]), 0)
            base = base * (1.0 + pen[act, None] * (1.0 - local / size))
        e = base * speeds_mat[act[:, None], ws] + cold[act, None]
        done = (rs + sconst[act, None]) + e
        # forced prefix: position j needs r_{j+1} <= min(done_0..done_j)
        pm = np.minimum.accumulate(np.where(valid, done, np.inf), axis=1)
        forced = np.empty_like(valid)
        forced[:, 0] = valid[:, 0]
        forced[:, 1:] = valid[:, 1:] & (rs[:, 1:] <= pm[:, :-1])
        forced = np.logical_and.accumulate(forced, axis=1)
        adv = forced.sum(axis=1)

        rows = np.repeat(act, adv)
        wsel = ws[forced]
        dsel = done[forced]
        fsel = flat[forced]
        ready[rows, wsel] = dsel
        tb[rows, wsel] = tb_base[rows] + cidx[forced] + 1.0
        wlog[fsel] = wsel
        e_log[fsel] = e[forced]
        done_log[fsel] = dsel
        cursor[act] += adv

    return _lane_stats(lanes, offs, nch, wlog, e_log, s_log, done_log)


def _run_band_chunkwise(lanes: list[_Lane], numa: bool):
    """Step the mutex (FAC-family) band in lockstep, one chunk index per
    numpy step: the critical section couples every worker of a lane
    through ``lock_free``, so assignments cannot be batched into forced
    rounds.  FAC chunk counts are O(P log N), so this path is never the
    bottleneck.  Lanes are sorted by descending chunk count: the active
    set is always a prefix, and every per-step array op is a view over
    live lanes only.

    Returns per-lane (busy, sched, finish, worker_log) with the same
    float64 operation order as the event-driven oracle, so results agree
    bit-for-bit.
    """
    lanes = sorted(lanes, key=lambda l: -len(l.plan))
    L = len(lanes)
    pmax = max(l.p for l in lanes)
    nch, offs, sizes_flat, starts_flat, base_flat = _flatten_lanes(lanes)

    ready = np.full((L, pmax), np.inf)
    tb = np.tile(np.arange(pmax, dtype=float), (L, 1))
    speeds_mat = np.ones((L, pmax))
    finish = np.zeros((L, pmax))
    busy = np.zeros((L, pmax))
    sched = np.zeros((L, pmax))
    tb_base = np.empty(L)
    cold = np.empty(L)
    for li, l in enumerate(lanes):
        ready[li, :l.p] = 0.0
        speeds_mat[li, :l.p] = l.speeds_eff
        tb_base[li] = float(l.n)
        cold[li] = l.cfg.chunk_cold_cost

    if numa:
        pen = np.asarray([l.cfg.numa_penalty for l in lanes])
        bounds = np.zeros((L, pmax + 1), np.int64)
        for li, l in enumerate(lanes):
            bounds[li, :l.p + 1] = np.linspace(0, l.n, l.p + 1).astype(np.int64)
    leader_flat = np.concatenate([l.plan.leader for l in lanes])
    o_disp_v = np.asarray([l.overhead.o_dispatch for l in lanes])
    o_sync_v = np.asarray(
        [l.overhead.sync_cost(l.spec.meta.sync) for l in lanes])
    o_calc_v = np.asarray(
        [l.overhead.calc_cost(l.spec.meta.o_cs) for l in lanes])
    lock_free = np.zeros(L)

    wlog = np.zeros(len(sizes_flat), np.int32)
    ar_full = np.arange(L)
    act = L
    for k in range(int(nch[0])):
        while act and nch[act - 1] <= k:
            act -= 1
        r = ready[:act]
        t = r.min(axis=1)
        # heap order: least ready time, then least insertion tiebreak
        cand = np.where(r == t[:, None], tb[:act], np.inf)
        w = cand.argmin(axis=1)
        ar = ar_full[:act]
        idx = offs[:act] + k
        base = base_flat[idx]
        if numa:
            size = sizes_flat[idx]
            lo = starts_flat[idx]
            hi = lo + size
            local = np.maximum(
                np.minimum(hi, bounds[ar, w + 1])
                - np.maximum(lo, bounds[ar, w]), 0)
            base = base * (1.0 + pen[:act] * (1.0 - local / size))
        e = base * speeds_mat[ar, w] + cold[:act]
        # serialize through the critical section: the batch leader pays
        # the full chunk calculation, followers re-read the shared value
        start = np.maximum(t, lock_free[:act])
        wait = start - t
        hold = o_sync_v[:act] + np.where(
            leader_flat[idx], o_calc_v[:act], 0.2 * o_calc_v[:act])
        lock_free[:act] = start + hold
        s = o_disp_v[:act] + wait + hold
        done = t + s + e
        ready[ar, w] = done
        finish[ar, w] = done
        busy[ar, w] += e
        sched[ar, w] += s
        tb[ar, w] = tb_base[:act] + (k + 1)
        wlog[idx] = w

    return [(l, busy[li, :l.p], sched[li, :l.p], finish[li, :l.p],
             wlog[offs[li]:offs[li] + nch[li]])
            for li, l in enumerate(lanes)]


# ---------------------------------------------------------------------------
# Lockstep band — adaptive / worker-dependent techniques, vectorized
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ALane:
    """One config on the lockstep (adaptive) band.

    Unlike the fast band's :class:`_Lane` (one lane per (config,
    timestep)), an adaptive lane spans *all* its timesteps: AWF/AF/BOLD
    state carries across ``begin_instance`` boundaries, so instances must
    run sequentially per config — the vectorization axis is the configs.
    """

    config_idx: int
    cfg: BatchConfig
    spec: ScheduleSpec
    kw: dict
    overhead: OverheadModel


def _run_lockstep_band(groups: list[list[_ALane]], record_chunks: bool):
    """Advance every adaptive lane chunk-round by chunk-round,
    bit-identically to the event-driven oracle.

    The oracle's event loop feeds ``complete_chunk`` immediately after
    each grant (the measurement is computed at request time), so the
    adaptive state is a deterministic recurrence over the per-lane chunk
    sequence — and since lanes share no state, stepping every lane's
    k-th chunk in one NumPy round reproduces each lane's event order
    exactly.  Per round: pop the (ready, tiebreak)-least worker per
    lane, ask each group's ``step_batch`` machine for the thresholded
    chunk sizes, clamp, update the factoring/adaptive bookkeeping
    (``granted``), charge the atomic-path scheduling + execution costs
    with the same float64 operand order as the oracle, and feed the
    measurement back (``complete``).

    ``groups`` partitions the lanes by (technique, p): each group owns
    one vectorized machine whose state arrays are exactly (Lg, p) — the
    condition for NumPy's pairwise reductions to match the scalar
    reference — while the *engine* arithmetic (worker pop, execution
    cost, clock/telemetry scatters) runs once per round over the union
    of all alive lanes, padded to the band-wide max p.  That split is
    what makes the band fast: the per-round Python/NumPy dispatch cost
    amortizes over every adaptive config in the grid, not one
    technique's slice of it.

    Returns per-lane lists of per-instance
    ``(busy, sched, finish, n_chunks, chunks)`` tuples.
    """
    lanes = [lane for group in groups for lane in group]
    L = len(lanes)
    G = len(groups)
    lane_steal = np.zeros(L, bool)
    pmax = max(l.cfg.p for l in lanes)
    pvec = np.asarray([l.cfg.p for l in lanes], np.int64)
    n = np.asarray([l.cfg.workload.n for l in lanes], np.int64)
    g_start = np.zeros(G, np.int64)  # first global lane id per group
    machines = []
    off = 0
    for gi, group in enumerate(groups):
        g_start[gi] = off
        off += len(group)
        machines.append(group[0].spec.entry.step_batch(
            n=[l.cfg.workload.n for l in group], p=group[0].cfg.p,
            chunk_param=[l.spec.chunk_param for l in group],
            kws=[l.kw for l in group]))
    # steal-band machines (core/stealing.py) own per-lane deque state and
    # return chunk *positions* + victim-probe counts instead of sizes
    # against the engine's shared-queue cursor
    steal_g = [hasattr(m, "pops") for m in machines]
    any_steal = any(steal_g)
    for gi, group in enumerate(groups):
        if steal_g[gi]:
            lane_steal[g_start[gi]:g_start[gi] + len(group)] = True

    # flat concatenated cost prefix sums (shared per unique workload)
    offs = np.zeros(L, np.int64)
    parts: list[np.ndarray] = []
    seen: dict[int, int] = {}
    total = 0
    for li, l in enumerate(lanes):
        wkl = l.cfg.workload
        coff = seen.get(id(wkl))
        if coff is None:
            csum = np.concatenate([[0.0], np.cumsum(wkl.costs)])
            seen[id(wkl)] = coff = total
            parts.append(csum)
            total += len(csum)
        offs[li] = coff
    csum_flat = np.concatenate(parts)

    cold = np.asarray([l.cfg.chunk_cold_cost for l in lanes])
    sconst = np.asarray([
        (l.overhead.o_dispatch + l.overhead.sync_cost(l.spec.meta.sync))
        + l.overhead.calc_cost(l.spec.meta.o_cs) for l in lanes])
    ost = np.asarray([l.overhead.o_steal for l in lanes])
    pen = np.asarray([l.cfg.numa_penalty for l in lanes])
    use_numa = bool((pen > 0.0).any())
    if use_numa:
        bounds = np.zeros((L, pmax + 1), np.int64)
        for li, l in enumerate(lanes):
            bounds[li, :pvec[li] + 1] = np.linspace(
                0, l.cfg.workload.n, pvec[li] + 1).astype(np.int64)
    tb_base = n.astype(np.float64)
    tsteps = np.asarray([l.cfg.timesteps for l in lanes], np.int64)

    out: list[list] = [[] for _ in range(L)]
    for ts in range(int(tsteps.max())):
        galive: list[np.ndarray] = []  # per-group alive global lane ids
        for gi, group in enumerate(groups):
            act = np.flatnonzero(tsteps[g_start[gi]:g_start[gi]
                                        + len(group)] > ts)
            machines[gi].begin_instance(ts, act)
            galive.append(act + g_start[gi])
        ready = np.full((L, pmax), np.inf)
        tb = np.tile(np.arange(pmax, dtype=float), (L, 1))
        busy = np.zeros((L, pmax))
        sched = np.zeros((L, pmax))
        scheduled = np.zeros(L, np.int64)
        reqidx = np.zeros(L, np.int64)
        speeds = np.ones((L, pmax))
        for ga in galive:
            for li in ga:
                p_l = pvec[li]
                ready[li, :p_l] = 0.0
                speeds[li, :p_l] = _lane_speeds(lanes[li].cfg, ts)
        logs: list[list] = [[] for _ in range(L)]
        while True:
            segs = [(gi, ga) for gi, ga in enumerate(galive) if len(ga)]
            if not segs:
                break
            a = (segs[0][1] if len(segs) == 1
                 else np.concatenate([ga for _, ga in segs]))
            r = ready[a]
            t = r.min(axis=1)
            # heap order: least ready time, then least insertion tiebreak
            cand = np.where(r == t[:, None], tb[a], np.inf)
            w = cand.argmin(axis=1)
            rem = n[a] - scheduled[a]
            ridx = reqidx[a]
            size = np.empty(len(a), np.int64)
            # steal lanes overwrite start with deque positions; the
            # shared-queue cursor stays correct for everyone else
            start = scheduled[a]
            att = np.zeros(len(a)) if any_steal else None
            vic = (np.empty(len(a), np.int64)
                   if any_steal and record_chunks else None)
            pos = 0
            for gi, ga in segs:
                sl = slice(pos, pos + len(ga))
                if steal_g[gi]:
                    st_, sz_, at_, vi_ = machines[gi].pops(
                        ga - g_start[gi], w[sl])
                    start[sl] = st_
                    size[sl] = sz_
                    att[sl] = at_
                    if vic is not None:
                        vic[sl] = vi_
                else:
                    size[sl] = machines[gi].sizes(
                        ga - g_start[gi], w[sl], rem[sl], ridx[sl])
                pos += len(ga)
            # identity for steal lanes: host grants already satisfy
            # 1 <= size <= remaining
            size = np.maximum(1, np.minimum(size, rem))
            rem_after = rem - size
            batch = np.empty(len(a), np.int64) if record_chunks else None
            pos = 0
            for gi, ga in segs:
                sl = slice(pos, pos + len(ga))
                if steal_g[gi]:
                    if record_chunks:
                        # steal grants carry batch == request index
                        batch[sl] = ridx[sl]
                    pos += len(ga)
                    continue
                b = machines[gi].granted(
                    ga - g_start[gi], w[sl], size[sl], rem_after[sl],
                    ridx[sl])
                if record_chunks:
                    batch[sl] = b
                pos += len(ga)
            scheduled[a] += size
            reqidx[a] += 1
            idx = offs[a] + start
            base = csum_flat[idx + size] - csum_flat[idx]
            if use_numa:
                hi = start + size
                local = np.maximum(
                    np.minimum(hi, bounds[a, w + 1])
                    - np.maximum(start, bounds[a, w]), 0)
                base = base * (1.0 + pen[a] * (1.0 - local / size))
            e = base * speeds[a, w] + cold[a]
            # same float64 operand order as the oracle: s_cost += attempts
            # * o_steal (the += 0.0 for non-steal lanes is bit-neutral)
            s = sconst[a] + att * ost[a] if any_steal else sconst[a]
            pos = 0
            for gi, ga in segs:
                sl = slice(pos, pos + len(ga))
                machines[gi].complete(ga - g_start[gi], w[sl], size[sl],
                                      e[sl], s[sl])
                pos += len(ga)
            done = t + s + e
            # ready doubles as the finish log: a worker's clock only ever
            # moves to its (monotone) chunk completion time, so at
            # instance end ready[:p] == per-worker finish exactly
            ready[a, w] = done
            busy[a, w] += e
            sched[a, w] += s
            tb[a, w] = tb_base[a] + reqidx[a]
            if record_chunks:
                for j, li in enumerate(a):
                    if lane_steal[li]:
                        logs[li].append(StealGrant(
                            start=int(start[j]), size=int(size[j]),
                            batch=int(batch[j]), worker=int(w[j]),
                            steal_attempts=int(att[j]), victim=int(vic[j])))
                    else:
                        logs[li].append(ChunkGrant(
                            start=int(start[j]), size=int(size[j]),
                            batch=int(batch[j]), worker=int(w[j])))
            for gi, ga in segs:
                fin = scheduled[ga] >= n[ga]
                if fin.any():
                    galive[gi] = ga[~fin]
        for gi, group in enumerate(groups):
            act = np.flatnonzero(tsteps[g_start[gi]:g_start[gi]
                                        + len(group)] > ts)
            machines[gi].end_instance(act)
            for li in act + g_start[gi]:
                p_l = pvec[li]
                out[li].append((busy[li, :p_l].copy(),
                                sched[li, :p_l].copy(),
                                ready[li, :p_l].copy(), int(reqidx[li]),
                                logs[li] if record_chunks else None))
    return [(lanes[li], out[li]) for li in range(L)]


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _stateful_perturb(perturb: Optional[Callable]) -> bool:
    if perturb is None:
        return False
    try:
        return len(inspect.signature(perturb).parameters) >= 3
    except (TypeError, ValueError):  # pragma: no cover - exotic callables
        return True


def _dedup_key(cfg: BatchConfig, spec: ScheduleSpec,
               ov: OverheadModel, prof: ProfileModel):
    """Memoization key for configs that are provably identical runs.

    A campaign grid typically carries a seed axis for statistical
    repetitions, but the simulator is deterministic: the seed only
    reaches seed-consuming techniques (RAND) and rng-taking perturb
    callbacks.  For every other config the seed axis re-runs the exact
    same computation — the batch engine shares it (per-call `simulate`
    cannot: it sees one config at a time).  Returns None when sharing is
    unsafe (prebuilt instances, opaque perturb callables are keyed by
    identity but seed-consumers never dedup across seeds)."""
    if isinstance(cfg.technique, Technique):
        return None
    seed_live = (_accepts_seed(spec)           # RAND-style technique RNG
                 or _stateful_perturb(cfg.perturb))  # rng-taking perturb
    return (
        spec, id(cfg.workload), cfg.p, cfg.timesteps,
        None if cfg.speeds is None else tuple(cfg.speeds),
        cfg.numa_penalty, cfg.chunk_cold_cost,
        None if cfg.weights is None else tuple(cfg.weights),
        None if cfg.perturb is None else id(cfg.perturb),
        ov, prof,
        cfg.seed if seed_live else None,
    )


def _accepts_seed(spec: ScheduleSpec) -> bool:
    from .simulator import _accepts_seed as accepts
    return accepts(spec.entry.cls)


def _copy_result(res: SimResult) -> SimResult:
    """Fresh record arrays for a deduplicated grid point, so callers can
    mutate per-config results independently.  Oracle-path results keep
    their (shared) post-run technique instance: a deduplicated config *is*
    the same run, so the state machine that produced it is the same
    object."""
    r = res.record
    return SimResult(
        record=dataclasses.replace(
            r,
            thread_times=r.thread_times.copy(),
            thread_finish=r.thread_finish.copy(),
            chunks=None if r.chunks is None else list(r.chunks),
        ),
        technique=res.technique,
        engine_used=res.engine_used,
    )


def _oracle_fallback_reason(cfg: BatchConfig, spec: Optional[ScheduleSpec],
                            fast_engine: str) -> Optional[str]:
    """Why a config that *looks* eligible for a vectorized band lands on
    the event oracle — None when the oracle routing is intentional
    (non-adaptive plan-band configs never hit this: they take the plan
    band, and a plan-band config reaching the oracle is always one of the
    causes below)."""
    if isinstance(cfg.technique, Technique):
        return ("prebuilt Technique instance (host state machines cannot "
                "be vectorized)")
    if _stateful_perturb(cfg.perturb):
        return ("3-arg stateful perturb callback (per-chunk rng draws "
                "must replay in event order)")
    meta = spec.meta
    if spec.entry.step_batch is None:
        return (f"technique {spec.technique!r} has no step_batch form "
                f"(bind one with repro_torch.core.schedule.bind_step_batch)")
    if meta.sync == "mutex":
        return (f"technique {spec.technique!r} uses mutex sync (the "
                f"{fast_engine} band models the atomic request path)")
    return None  # pragma: no cover - routing covers all causes above


def _note_fallback(strict, engine: str, reason: str) -> None:
    """Apply the ``strict`` knob to one silent-fallback event."""
    msg = (f"simulate_batch: config falls back to the event oracle "
           f"instead of the {engine} band: {reason}")
    if strict is True:
        raise RuntimeError(msg)
    if strict == "warn":
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    elif strict is not False:
        raise ValueError(
            f"strict must be False, 'warn', or True, got {strict!r}")


def simulate_batch(
    configs: Sequence[BatchConfig],
    *,
    overhead: OverheadModel = OverheadModel(),
    profile: ProfileModel = EXACT_PROFILE,
    recorder: Optional[LoopRecorder] = None,
    record_chunks: bool = False,
    strict=False,
) -> list[list[SimResult]]:
    """Simulate a grid of configurations in one vectorized pass.

    Returns one ``list[SimResult]`` per config (one entry per timestep),
    exactly like calling :func:`repro_torch.core.simulate` per config — and
    with identical results: worker-agnostic techniques run on the
    plan-precompute fast path, adaptive / worker-dependent ones with a
    registered ``step_batch`` form (the whole built-in AWF/AF/mAF/BOLD/
    WF2 family) on the vectorized lockstep band, and only prebuilt
    ``Technique`` instances, rng-taking 3-arg ``perturb`` callbacks, and
    ``step_batch``-less plugins on the event-driven oracle.  A 2-arg
    ``perturb(ts, worker)`` must be a pure function (the contract
    `simulate` documents); the engine cannot detect impurity from the
    signature.  Grid points that are provably the same run
    (e.g. the statistical-repetition seed axis on a technique that never
    reads the seed) are computed once and shared; ``recorder`` still
    receives one record per (config, timestep), in config order.

    Every returned result is tagged with the engine that produced it
    (``SimResult.engine_used``: ``"plan"``, ``"lockstep"``, or
    ``"event"``).  ``strict`` controls how a fallback to the per-chunk
    event oracle is reported: ``False`` (default) is silent, ``"warn"``
    emits a ``RuntimeWarning`` naming the config's reason, ``True``
    raises ``RuntimeError`` — so campaign callers scaling to large grids
    can detect the slow path instead of discovering it in wall-clock.
    """
    if strict not in (False, "warn", True):
        raise ValueError(
            f"strict must be False, 'warn', or True, got {strict!r}")
    results: list[Optional[list[SimResult]]] = [None] * len(configs)
    fast_lanes: list[_Lane] = []
    step_lanes: list[_ALane] = []
    plan_cache: dict = {}
    memo: dict = {}          # dedup key -> primary config index
    aliases: dict[int, int] = {}  # alias config index -> primary index

    for ci, cfg in enumerate(configs):
        ov = cfg.overhead if cfg.overhead is not None else overhead
        prof = cfg.profile if cfg.profile is not None else profile
        band = "oracle"
        spec = None
        if not isinstance(cfg.technique, Technique):
            spec = resolve(cfg.technique, chunk_param=cfg.chunk_param)
            if cfg.workload.n <= 0 or cfg.p <= 0:
                # the oracle raises this from Technique.__init__; the
                # vectorized bands never build a host instance, so the
                # contract ("identical to per-config simulate") is
                # enforced here before a band could fabricate a result
                raise ValueError(
                    f"need n>0, p>0, got n={cfg.workload.n} p={cfg.p}")
            meta = spec.meta
            if not _stateful_perturb(cfg.perturb):
                if not (meta.adaptive
                        or getattr(meta, "worker_dependent", False)):
                    band = "plan"
                elif (spec.entry.step_batch is not None
                      and meta.sync != "mutex"):
                    # the lockstep band models the atomic request path;
                    # a mutex-sync step_batch plugin stays on the oracle
                    band = "lockstep"
            key = _dedup_key(cfg, spec, ov, prof)
            if key is not None:
                prev = memo.setdefault(key, ci)
                if prev != ci:
                    aliases[ci] = prev
                    continue
        if band == "oracle":
            if strict is not False:
                reason = _oracle_fallback_reason(cfg, spec, "lockstep")
                if reason is not None:
                    _note_fallback(strict, "lockstep", reason)
            results[ci] = simulate(
                cfg.technique, cfg.workload, cfg.p, cfg.chunk_param,
                timesteps=cfg.timesteps, speeds=cfg.speeds,
                numa_penalty=cfg.numa_penalty,
                chunk_cold_cost=cfg.chunk_cold_cost, overhead=ov,
                record_chunks=record_chunks,
                weights=cfg.weights, perturb=cfg.perturb, profile=prof,
                seed=cfg.seed)
            continue
        kw = _technique_kwargs(spec, cfg.workload, cfg.p, ov, cfg.weights,
                               prof, seed=cfg.seed)
        if band == "lockstep":
            step_lanes.append(_ALane(config_idx=ci, cfg=cfg, spec=spec,
                                     kw=kw, overhead=ov))
            results[ci] = [None] * cfg.timesteps  # type: ignore[list-item]
            continue
        plans = _plans_for(spec, cfg.workload.n, cfg.p, cfg.timesteps, kw,
                           plan_cache)
        for ts in range(cfg.timesteps):
            fast_lanes.append(_Lane(
                config_idx=ci, instance=ts, cfg=cfg, spec=spec,
                plan=plans[ts], speeds_eff=_lane_speeds(cfg, ts),
                overhead=ov))
        results[ci] = [None] * cfg.timesteps  # type: ignore[list-item]

    # band by (mutex?, numa?) so each inner loop stays minimal
    bands: dict[tuple[bool, bool], list[_Lane]] = {}
    for lane in fast_lanes:
        key = (lane.spec.meta.sync == "mutex", lane.cfg.numa_penalty > 0.0)
        bands.setdefault(key, []).append(lane)

    for (mutex, numa), band in bands.items():
        for lane, busy, sched, finish, lane_w in _run_lane_band(
                band, mutex=mutex, numa=numa, record_chunks=record_chunks):
            cfg, spec, plan = lane.cfg, lane.spec, lane.plan
            chunks = None
            if record_chunks:
                chunks = [
                    ChunkGrant(start=int(plan.starts[i]),
                               size=int(plan.sizes[i]),
                               batch=int(plan.batches[i]),
                               worker=int(lane_w[i]))
                    for i in range(len(plan))
                ]
            rec = LoopInstanceRecord(
                loop=cfg.workload.name,
                technique=spec.technique,
                instance=lane.instance,
                p=cfg.p,
                n=cfg.workload.n,
                chunk_param=spec.chunk_param,
                t_par=float(finish.max()),
                thread_times=busy + sched,
                thread_finish=finish.copy(),
                n_chunks=len(plan),
                sched_time=float(sched.sum()),
                chunks=chunks,
            )
            results[lane.config_idx][lane.instance] = SimResult(
                record=rec, engine_used="plan")

    # lockstep (adaptive) band: lanes grouped by (technique, p) — one
    # vectorized machine per group (reductions over exactly p contiguous
    # elements), all groups advanced by one merged engine loop
    groups: dict[tuple[str, int], list[_ALane]] = {}
    for alane in step_lanes:
        groups.setdefault((alane.spec.technique, alane.cfg.p),
                          []).append(alane)
    if groups:
        for alane, instances in _run_lockstep_band(list(groups.values()),
                                                   record_chunks):
            cfg, spec = alane.cfg, alane.spec
            for ts, (busy, sched, finish, nchunks, chunks) in \
                    enumerate(instances):
                rec = LoopInstanceRecord(
                    loop=cfg.workload.name,
                    technique=spec.technique,
                    instance=ts,
                    p=cfg.p,
                    n=cfg.workload.n,
                    chunk_param=spec.chunk_param,
                    t_par=float(finish.max()),
                    thread_times=busy + sched,
                    thread_finish=finish,
                    n_chunks=nchunks,
                    sched_time=float(sched.sum()),
                    chunks=chunks,
                )
                results[alane.config_idx][ts] = SimResult(
                    record=rec, engine_used="lockstep")

    for ci, prev in aliases.items():
        results[ci] = [_copy_result(r) for r in results[prev]]

    if recorder is not None:
        # one record per (config, timestep), in config order — the same
        # stream sequential per-config simulate calls would produce
        for per_config in results:
            for res in per_config:
                recorder.add(res.record)
    return results  # type: ignore[return-value]
