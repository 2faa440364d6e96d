"""Discrete-event simulator of LB4OMP's shared-queue self-scheduling
(NumPy copy of ``src/repro/core/simulator.py`` for the PyTorch port).

Reproduces the paper's execution model bit-faithfully at chunk granularity:
P workers repeatedly (request -> synchronize -> calculate chunk -> execute)
against a central queue of N loop iterations, with the paper's three
overhead factors (Sec. 4.2) modelled explicitly:

    o_sr    number of scheduling rounds  == number of chunks (emergent)
    o_cs    chunk-calculation cost       == spec.o_cs * O_UNIT seconds
    o_sync  synchronization cost         == atomic fetch-add, or a *mutex*
            critical section (FAC) that serializes concurrent requests

plus the two systemic effects the paper highlights:

    * ccNUMA / locality loss: iterations have a first-touch "owner" worker
      (the static split); executing someone else's iterations costs
      ``numa_penalty`` extra per remote iteration — this is what makes
      dynamic techniques lose to STATIC on STREAM/GROMACS-style loops.
    * heterogeneity / system variation: per-worker ``speeds`` multipliers
      (and optional time-varying perturbation) — this is what the adaptive
      techniques (AWF*/AF/mAF) exploit.

The simulator is the *reference* substrate for the paper's campaign
(benchmarks/), and the oracle against which the SPMD planner
(`core/planner.py`, `core/torch_sched.py`) is property-tested.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import inspect
from typing import Optional, Sequence

import numpy as np

from .metrics import LoopInstanceRecord, LoopRecorder
from .schedule import ScheduleSpec, resolve
from .techniques import Technique
from .workloads import Workload

__all__ = ["OverheadModel", "ProfileModel", "EXACT_PROFILE", "NOISY_PROFILE",
           "SimResult", "simulate", "profile_workload"]

#: one "overhead unit" in seconds — the cost of a handful of arithmetic ops
#: in the RTL dispatch path.  Calibrated so that STATIC/SS/GSS relative
#: overheads land in the regime of the paper's Fig. 7.
O_UNIT = 25e-9


@dataclasses.dataclass(frozen=True)
class OverheadModel:
    """Per-request scheduling cost model (seconds)."""

    o_atomic: float = 40e-9        # atomic fetch-add on the queue head
    o_mutex_acquire: float = 120e-9  # uncontended lock/unlock pair
    o_unit: float = O_UNIT         # multiplier for TechniqueSpec.o_cs
    o_dispatch: float = 60e-9      # fixed RTL dispatch path cost / request
    #: one work-stealing victim probe (remote CAS + cache-line transfer on
    #: the victim's deque anchor) — charged per *attempt*, failed probes
    #: included, for steal-band grants (`core/stealing.py`); the local-pop
    #: common case pays only o_dispatch + o_cs, never this
    o_steal: float = 250e-9

    def sync_cost(self, sync: str) -> float:
        if sync == "none":
            return 0.0
        if sync == "atomic":
            return self.o_atomic
        if sync == "mutex":
            return self.o_mutex_acquire
        raise ValueError(f"unknown sync kind {sync!r}")

    def calc_cost(self, o_cs: float) -> float:
        return o_cs * self.o_unit

    def per_request(self, spec) -> float:
        """Estimate of h (per-round overhead) for FSC/BOLD profiling."""
        return self.o_dispatch + self.sync_cost(spec.sync) + self.calc_cost(spec.o_cs)


@dataclasses.dataclass
class SimResult:
    """One loop-instance outcome.  ``technique`` is the live host state
    machine that produced it — ``None`` for results materialized by the
    vectorized batch engine (`core/batch_sim.py`), which plans chunks
    without driving a host instance.

    ``engine_used`` names the engine that materialized the record —
    ``"event"`` (the per-chunk oracle here), ``"plan"`` / ``"lockstep"``
    (the batch engine's precomputed and adaptive bands), or ``"graph"``
    (the torch campaign engine in `core/graph_sim.py`) — so campaign
    callers can detect a silent fallback to a slower engine."""

    record: LoopInstanceRecord
    technique: Optional[Technique] = None
    engine_used: Optional[str] = None

    @property
    def t_par(self) -> float:
        return self.record.t_par


@dataclasses.dataclass(frozen=True)
class ProfileModel:
    """Measurement model for the pre-execution profiling run (Sec. 3.2).

    Per-iteration timing on fine-granularity loops is polluted by the timer
    itself and by OS noise; the paper attributes FAC/mFAC's degenerate small
    chunks on GROMACS/STREAM to exactly this ("profiling the execution of
    each loop iteration may adversely influence execution performance, and
    may lead FAC and mFAC to calculate very small chunk sizes", Sec. 4.2).

        sigma_meas^2 = sigma^2 + noise_floor^2 + outlier_p * outlier_t^2
        mu_meas      = mu + timer_cost
    """

    noise_floor: float = 0.0   # RDTSCP/instrumentation jitter (s)
    timer_cost: float = 0.0    # additive per-iteration timer cost (s)
    outlier_p: float = 0.0     # probability of an OS-noise outlier sample
    outlier_t: float = 0.0     # magnitude of an outlier (s)

    def measure(self, w: Workload) -> tuple[float, float]:
        var = (w.sigma ** 2 + self.noise_floor ** 2
               + self.outlier_p * self.outlier_t ** 2)
        return w.mu + self.timer_cost, float(np.sqrt(var))


#: ideal profiling (exact stats) — default for compute-bound loops.
EXACT_PROFILE = ProfileModel()

#: realistic timer for nanosecond-granularity loops (Fig. 7/8 regime):
#: RDTSCP jitter plus rare OS-preemption outliers (~100us timeslices) that
#: dominate the measured sigma when iterations are tens of nanoseconds.
NOISY_PROFILE = ProfileModel(noise_floor=50e-9, timer_cost=25e-9,
                             outlier_p=1e-3, outlier_t=100e-6)


def profile_workload(w: Workload,
                     profile: ProfileModel = EXACT_PROFILE) -> tuple[float, float]:
    """The paper's OMP_SCHEDULE=profiling feature: collect mu/sigma of the
    iteration execution times prior to the real run (Sec. 3.2)."""
    return profile.measure(w)


@functools.lru_cache(maxsize=None)
def _accepts_seed(cls: type) -> bool:
    """Does this Technique subclass's ``_init`` consume a ``seed``?"""
    try:
        return "seed" in inspect.signature(cls._init).parameters
    except (TypeError, ValueError):  # pragma: no cover - builtins/exotic
        return False


def _technique_kwargs(spec: ScheduleSpec, w: Workload, p: int,
                      ov: OverheadModel,
                      weights: Optional[Sequence[float]],
                      profile: ProfileModel,
                      seed: Optional[int] = None) -> dict:
    """Feed profiling info to the techniques that require it."""
    meta = spec.meta
    kw: dict = {}
    if meta.requires_profiling:
        mu, sigma = profile_workload(w, profile)
        kw["mu"], kw["sigma"] = mu, sigma
        if spec.technique in ("fsc", "bold"):
            kw["h"] = ov.per_request(meta)
    if spec.technique == "wf2" and weights is not None:
        kw["weights"] = weights
    if seed is not None and _accepts_seed(spec.entry.cls):
        kw["seed"] = seed
    return kw


def _bind_perturb(perturb: Optional[callable], seed: int):
    """Resolve the perturbation callback.

    Two signatures are supported: ``f(timestep, worker)`` (deterministic,
    as before) and ``f(timestep, worker, rng)`` — the latter receives a
    ``numpy.random.Generator`` seeded from ``simulate``'s ``seed`` so
    stochastic system-variation models are reproducible per seed.
    """
    if perturb is None:
        return None
    try:
        nparams = len(inspect.signature(perturb).parameters)
    except (TypeError, ValueError):
        nparams = 2
    if nparams >= 3:
        rng = np.random.default_rng(seed)
        return lambda ts, wkr: perturb(ts, wkr, rng)
    return perturb


def simulate(
    technique: ScheduleSpec | str | Technique,
    workload: Workload,
    p: int,
    chunk_param: Optional[int] = None,
    *,
    timesteps: int = 1,
    speeds: Optional[Sequence[float]] = None,
    numa_penalty: float = 0.0,
    chunk_cold_cost: float = 0.0,
    overhead: OverheadModel = OverheadModel(),
    recorder: Optional[LoopRecorder] = None,
    record_chunks: bool = False,
    weights: Optional[Sequence[float]] = None,
    perturb: Optional[callable] = None,
    profile: ProfileModel = EXACT_PROFILE,
    seed: int = 0,
) -> list[SimResult]:
    """Simulate ``timesteps`` executions of the loop under one technique.

    Args:
      technique: a ScheduleSpec, an OMP_SCHEDULE-style string (``"fac2"``,
        ``"fac2,64"``, ``"runtime"`` to read $LB_SCHEDULE), or a prebuilt
        Technique object.  An explicit ``chunk_param`` argument overrides
        the spec's.
      workload: iteration costs (seconds).
      p: number of workers (threads).
      chunk_param: the OpenMP chunk parameter (threshold / fixed size).
      timesteps: loop instances (time-stepping application, T in Table 1).
      speeds: per-worker slowdown multipliers (>=1 slower); default all 1.
      numa_penalty: extra relative cost for remotely-owned iterations.
      chunk_cold_cost: fixed cost per *executed chunk* (cache warm-up /
        first-touch misses) — the 'loss of data locality' term that makes
        many small chunks expensive (paper Sec. 4.2/4.3).
      perturb: optional f(timestep, worker) -> extra multiplier, models
        system variation during execution (adaptive techniques should win).
        Must be a pure function of (timestep, worker) — the batch engine
        relies on that to evaluate it once per (timestep, worker).  For
        stochastic variation use the 3-argument variant
        f(timestep, worker, rng), which receives a Generator seeded from
        ``seed`` and always runs on the event-driven path.
      seed: seeds the stochastic elements of a run — it is forwarded to
        seed-consuming techniques (e.g. RAND's chunk-size RNG) and to
        3-argument ``perturb`` callbacks, so ``simulate(..., seed=k)`` is
        reproducible per ``k`` and varies across seeds.
    """
    n = workload.n
    if isinstance(technique, Technique):
        tech = technique
        tname = tech.spec.name
        chunk_param = tech.chunk_param
    else:
        spec = resolve(technique, chunk_param=chunk_param)
        tname = spec.technique
        chunk_param = spec.chunk_param
        kw = _technique_kwargs(spec, workload, p, overhead, weights, profile,
                               seed=seed)
        tech = spec.make(n=n, p=p, **kw)
    perturb = _bind_perturb(perturb, seed)

    csum = np.concatenate([[0.0], np.cumsum(workload.costs)])
    speeds_arr = np.ones(p) if speeds is None else np.asarray(speeds, float)
    if speeds_arr.shape != (p,):
        raise ValueError(f"speeds must have shape ({p},)")
    # first-touch owner of iteration i under the canonical static split
    owner_bounds = np.linspace(0, n, p + 1).astype(np.int64)

    sync = tech.spec.sync
    o_sync = overhead.sync_cost(sync)
    o_calc = overhead.calc_cost(tech.spec.o_cs)
    o_disp = overhead.o_dispatch

    results: list[SimResult] = []
    for ts in range(timesteps):
        tech.begin_instance(ts)
        busy = np.zeros(p)
        sched = np.zeros(p)
        finish = np.zeros(p)
        nchunks = 0
        chunk_log: list = []
        lock_free_at = 0.0
        # (ready_time, tiebreak, worker)
        heap = [(0.0, i, i) for i in range(p)]
        heapq.heapify(heap)
        seen_batches: set[int] = set()

        while heap:
            t, _, wkr = heapq.heappop(heap)
            grant = tech.next_chunk(wkr)
            if grant is None:
                finish[wkr] = max(finish[wkr], t)
                continue
            nchunks += 1
            if record_chunks:
                chunk_log.append(grant)

            # --- synchronization + chunk calculation -----------------------
            s_cost = o_disp + o_sync
            is_leader = grant.batch not in seen_batches
            seen_batches.add(grant.batch)
            if sync == "mutex":
                # serialize through the critical section
                start = max(t, lock_free_at)
                wait = start - t
                hold = o_sync + (o_calc if is_leader else 0.2 * o_calc)
                lock_free_at = start + hold
                s_cost = o_disp + wait + hold
            else:
                # atomic path: *every* thread computes its own chunk from the
                # shared counter (the mFAC reformulation, Sec. 3.1 — "more
                # computation, cheaper synchronization")
                s_cost += o_calc
            # steal-band grants: every victim probe (failed or not) pays
            # the steal latency on top of the local bookkeeping
            attempts = getattr(grant, "steal_attempts", 0)
            if attempts:
                s_cost += attempts * overhead.o_steal

            # --- execution --------------------------------------------------
            lo, hi = grant.start, grant.start + grant.size
            base = csum[hi] - csum[lo]
            if numa_penalty > 0.0:
                own_lo, own_hi = owner_bounds[wkr], owner_bounds[wkr + 1]
                local = max(0, min(hi, own_hi) - max(lo, own_lo))
                remote_frac = 1.0 - local / grant.size
                base *= 1.0 + numa_penalty * remote_frac
            mult = speeds_arr[wkr]
            if perturb is not None:
                mult *= perturb(ts, wkr)
            e_cost = base * mult + chunk_cold_cost

            tech.complete_chunk(wkr, grant, e_cost, s_cost)
            busy[wkr] += e_cost
            sched[wkr] += s_cost
            done = t + s_cost + e_cost
            finish[wkr] = max(finish[wkr], done)
            heapq.heappush(heap, (done, n + nchunks, wkr))

        tech.end_instance()
        rec = LoopInstanceRecord(
            loop=workload.name,
            technique=tname,
            instance=ts,
            p=p,
            n=n,
            chunk_param=chunk_param,
            t_par=float(finish.max()),
            thread_times=busy + sched,
            thread_finish=finish.copy(),
            n_chunks=nchunks,
            sched_time=float(sched.sum()),
            chunks=chunk_log if record_chunks else None,
        )
        if recorder is not None:
            recorder.add(rec)
        results.append(SimResult(record=rec, technique=tech,
                                 engine_used="event"))
    return results


def best_combination(summaries: list[dict]) -> dict[str, dict]:
    """The paper's 'Best' bar: per loop, the technique with min mean T_par."""
    best: dict[str, dict] = {}
    for row in summaries:
        cur = best.get(row["loop"])
        if cur is None or row["mean_t_par"] < cur["mean_t_par"]:
            best[row["loop"]] = row
    return best
