"""Serving-path resilience: straggler detection, chunk reclamation with
hedged re-execution, and circuit-breaker replica quarantine.

A copy of ``src/repro/serve/resilience.py`` for the PyTorch port (NumPy;
the reference module loads JAX through ``repro.core``).

The trial harness (``trials/``) documented the serving path's blind
spot: a node chunk granted to a replica *stays* there even if the replica
slows 10x mid-chunk (``serve/cluster.py`` — ``ReplicaSpeed`` applies from
the next pull), so ``thermal_degrade`` was the one un-gated scenario.  This
module is the failure-response layer that closes it, the node-level
robustness argument of Mohammed et al. (arXiv:1911.06714) made
executable:

* :class:`HealthTracker` — per-replica EWMA service-rate estimator plus
  a grant-age watchdog over the telemetry ``ClusterRouter`` /
  ``RequestScheduler.complete`` already collect; classifies replicas
  ``healthy`` / ``suspect`` / ``quarantined``.
* **Reclamation + hedging** — a chunk whose age exceeds its adaptive
  deadline (``deadline_k`` x EWMA-predicted span, with geometric backoff
  so transient blips don't thrash) has its unserved requests
  speculatively re-submitted; first completion per request wins and
  duplicate completions are folded idempotently, so the exactly-once
  invariant of ``repro_torch.trials`` holds under reclamation.  Reclamation is
  the failure-driven dual of the steal band: a :class:`ReclaimGrant` is
  the migration record, accounted like a ``StealGrant``.
* **Circuit breaker** — quarantined replicas leave the router's active
  set (no new grants), receive periodic single-request probes
  (``ClusterRouter.take_one``), and rejoin through ``set_active`` +
  ``Technique.inherit`` with neutralized node weights
  (:func:`~repro_torch.serve.elastic.neutralize_worker_state`) once a probe
  completes inside its deadline.  A replica that crash-loops
  (``crashes >= crash_loop_threshold``) rejoins *quarantined* and must
  earn its way back through probes.

:func:`simulate_cluster_resilient` is the event loop that composes all
three with the existing kill / recover / ``ScaleTo`` event heap.  Its
physics deliberately differ from ``simulate_cluster`` in one way: a
replica serves ONE node chunk at a time and a mid-chunk
``ReplicaSpeed`` event *interrupts* the chunk — completions before the
event stand, the remainder restarts at the new speed (the
``DecodeEngine`` re-prefill semantics).  That is exactly the physics in
which reclamation is measurable; with ``resilience=None`` the serving
stack runs the original ``simulate_cluster`` byte-identically.

Determinism: numpy-only, no wall clock, no RNG; heap ties are broken by
``(priority, replica, stamp)`` so equal-time activity has one order.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional, Sequence, Union

import numpy as np

from ..core.metrics import LoopRecorder
from .cluster import (ClusterRecord, ClusterRouter, ClusterEvent,
                      ReplicaKill, ReplicaRecover, ReplicaSpeed, ScaleTo,
                      TwoLevelSpec, _event_capacity, _validate_events)
from .scheduler import Request, RequestScheduler, simulate_serving

__all__ = [
    "HEALTHY",
    "SUSPECT",
    "QUARANTINED",
    "ResilienceConfig",
    "ReclaimGrant",
    "HealthTracker",
    "simulate_cluster_resilient",
]

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Tuning knobs for the resilience layer.

    ``ewma_alpha``
        Weight of the newest chunk observation in the per-replica
        slowness EWMA (1.0 == trust only the last chunk).
    ``deadline_k`` / ``deadline_floor``
        A chunk issued at *t* with predicted span *s* (EWMA slowness x
        ideal per-slot service span, plus any wait for not-yet-arrived
        requests) is overdue at ``t + max(deadline_floor, deadline_k *
        deadline_scale * s)``.  The floor keeps tiny chunks from
        thrashing on noise.
    ``backoff``
        Geometric growth of a chunk's re-armed deadline after each miss
        — and of ``deadline_scale`` after a *false* reclaim (the victim
        finished everything itself), so a merely-slow replica stops
        triggering hedges.
    ``max_hedges``
        Cap on speculative re-submissions per request (bounds duplicate
        work; the original in-flight copy is not counted).
    ``quarantine_misses``
        Consecutive deadline misses that trip the breaker.
    ``suspect_ratio`` / ``quarantine_ratio``
        Self-relative degradation thresholds on a chunk observation:
        ``observed_slowness / prior_ewma`` at or above ``suspect_ratio``
        marks the replica suspect, at or above ``quarantine_ratio``
        trips the breaker outright.  Self-relative, so a declared-slow
        replica in a heterogeneous cluster is not punished for being
        itself; a gradual thermal ramp below ``suspect_ratio`` per step
        is absorbed by the EWMA + deadline adaptation instead.
    ``probe_k`` / ``probe_backoff``
        A probe (single-request chunk on a quarantined replica) must
        finish within ``probe_k x median healthy slowness x cost``;
        failed or unissuable probes retry at geometrically growing gaps.
    ``crash_loop_threshold``
        Crash count at which a recovering replica rejoins quarantined
        (probation) instead of healthy.
    """

    ewma_alpha: float = 0.4
    deadline_k: float = 3.0
    deadline_floor: float = 0.02
    backoff: float = 1.5
    max_hedges: int = 2
    quarantine_misses: int = 2
    suspect_ratio: float = 2.5
    quarantine_ratio: float = 5.0
    probe_k: float = 3.0
    probe_backoff: float = 2.0
    crash_loop_threshold: int = 2

    def __post_init__(self):
        if self.ewma_alpha <= 0.0 or self.ewma_alpha > 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], "
                             f"got {self.ewma_alpha}")
        if self.deadline_k <= 0.0 or self.deadline_floor <= 0.0:
            raise ValueError("deadline_k and deadline_floor must be > 0")
        if self.backoff < 1.0 or self.probe_backoff < 1.0:
            raise ValueError("backoff factors must be >= 1")
        if self.max_hedges < 1:
            raise ValueError(f"max_hedges must be >= 1, "
                             f"got {self.max_hedges}")
        if self.quarantine_misses < 1:
            raise ValueError("quarantine_misses must be >= 1")
        if not (1.0 < self.suspect_ratio <= self.quarantine_ratio):
            raise ValueError("need 1 < suspect_ratio <= quarantine_ratio")


@dataclasses.dataclass(frozen=True)
class ReclaimGrant:
    """One reclaimed request: the failure-driven dual of a StealGrant.

    ``victim`` is the replica whose overdue chunk held the request;
    ``attempt`` counts this request's hedges so far (1 == first hedge).
    The hedged copy goes back through the router, so any healthy replica
    may serve it — whoever finishes first (victim included) wins.
    """

    time: float
    rid: int
    victim: int
    attempt: int


class HealthTracker:
    """Per-replica health: EWMA slowness + miss/crash counters.

    The tracker is advisory: ``observe`` / ``on_miss`` return the state
    the evidence calls for, but only the simulation loop *applies*
    quarantine (it owns the router membership and the
    never-quarantine-the-last-active-replica guard).  ``slowness`` is
    seeded from the declared ``replica_speed`` so heterogeneity is prior
    knowledge, not a fault signal.
    """

    def __init__(self, num_replicas: int,
                 cfg: Optional[ResilienceConfig] = None,
                 base_speed: Optional[Sequence[float]] = None):
        self.cfg = cfg if cfg is not None else ResilienceConfig()
        n = int(num_replicas)
        if n <= 0:
            raise ValueError(f"need num_replicas > 0, got {n}")
        if base_speed is None:
            self.slowness = np.ones(n)
        else:
            self.slowness = np.asarray(base_speed, dtype=np.float64).copy()
            if self.slowness.shape != (n,):
                raise ValueError(f"base_speed must have shape ({n},), "
                                 f"got {self.slowness.shape}")
        self.state = [HEALTHY] * n
        self.misses = [0] * n
        self.deadline_scale = np.ones(n)
        self.crashes = [0] * n

    def allowed_span(self, rep: int, span: float, wait: float = 0.0) -> float:
        """Deadline span for a chunk with ideal per-slot span ``span``
        issued now, ``wait`` being time until its last request arrives.

        ``wait`` is an additive offset — the chunk *cannot* finish
        before its last request arrives, so scaling it by the safety
        factor would let arrival-spanning chunks stall undetected for
        multiples of the wait."""
        c = self.cfg
        base = float(self.slowness[rep]) * float(span)
        return float(wait) + max(
            c.deadline_floor,
            c.deadline_k * float(self.deadline_scale[rep]) * base)

    def observe(self, rep: int, obs: float) -> str:
        """Fold one chunk's measured slowness (busy / cost); return the
        state the observation calls for."""
        c = self.cfg
        prior = max(float(self.slowness[rep]), 1e-12)
        deg = float(obs) / prior
        self.slowness[rep] = ((1.0 - c.ewma_alpha) * float(self.slowness[rep])
                              + c.ewma_alpha * float(obs))
        if deg >= c.quarantine_ratio:
            return QUARANTINED
        if deg >= c.suspect_ratio:
            if self.state[rep] == HEALTHY:
                self.state[rep] = SUSPECT
            return self.state[rep]
        # a clean completion is amnesty: misses reset, suspects heal
        self.misses[rep] = 0
        if self.state[rep] == SUSPECT:
            self.state[rep] = HEALTHY
        return self.state[rep]

    def on_miss(self, rep: int) -> str:
        """One deadline miss; returns the state the misses call for."""
        self.misses[rep] += 1
        if self.misses[rep] >= self.cfg.quarantine_misses:
            return QUARANTINED
        if self.state[rep] == HEALTHY:
            self.state[rep] = SUSPECT
        return self.state[rep]

    def on_kill(self, rep: int) -> None:
        self.crashes[rep] += 1
        self.misses[rep] = 0
        self.state[rep] = HEALTHY

    def relax(self, rep: int) -> None:
        """False reclaim: the victim finished everything itself — widen
        its future deadlines so a merely-slow replica stops thrashing."""
        self.deadline_scale[rep] *= self.cfg.backoff

    def reset(self, rep: int, slowness: Optional[float] = None) -> None:
        """Fresh start (recovery / rejoin): clear misses and deadline
        scale; optionally re-seed the slowness prior."""
        self.state[rep] = HEALTHY
        self.misses[rep] = 0
        self.deadline_scale[rep] = 1.0
        if slowness is not None:
            self.slowness[rep] = float(slowness)

    def healthy_slowness(self, active: Sequence[int]) -> float:
        """Median EWMA slowness over non-quarantined ``active`` replicas
        (the probe-deadline yardstick); 1.0 when none qualify."""
        vals = [float(self.slowness[r]) for r in active
                if self.state[r] != QUARANTINED]
        if not vals:
            return 1.0
        return float(np.median(np.asarray(vals)))


@dataclasses.dataclass
class _Chunk:
    """One in-flight node chunk (or probe) on one replica."""

    rep: int
    start: float
    seg_start: float          # current segment's start (reset on restart)
    speed: float              # cost multiplier of the current segment
    reqs: list                # current segment's requests
    completions: list         # current segment's (rid, finish)
    finish: float
    busy: float               # current segment's summed slot busy
    allowed: float            # live deadline span (backoff grows it)
    cost_seg: float           # summed cost of the current segment
    span: float               # unit-speed duration of the segment
    reported_busy: float = 0.0  # busy folded from interrupted segments
    fold_stamp: int = -1
    deadline_stamp: int = -1
    hedged: dict = dataclasses.field(default_factory=dict)  # rid -> attempt
    probe: bool = False
    probe_failed: bool = False
    misses: int = 0


def simulate_cluster_resilient(
        requests: Sequence[Request], num_replicas: int,
        workers_per_replica: int = 4,
        schedule: Union[TwoLevelSpec, str] = "awf_b/fac2",
        replica_speed: Optional[Sequence[float]] = None,
        recorder: Optional[LoopRecorder] = None,
        loop: str = "cluster",
        events: Sequence[ClusterEvent] = (),
        return_completions: bool = False,
        resilience: Optional[ResilienceConfig] = None) -> dict:
    """``simulate_cluster`` with the resilience layer switched on.

    Same stats contract as :func:`~repro_torch.serve.cluster.simulate_cluster`
    plus a ``"resilience"`` sub-dict (reclaim / duplicate / quarantine /
    probe counters and final health states).  Differences in physics:

    * a replica serves one node chunk at a time (pull on fold, not on
      first-slot-hungry) with a fresh intra-node scheduler per chunk;
    * ``ReplicaSpeed`` *interrupts* an in-flight chunk: completions up
      to the event stand, the remainder restarts at the new speed —
      this closes the chunk-atomicity blind spot the thermal trial
      scenarios probe;
    * overdue chunks hedge their unserved requests back through the
      router (first completion wins, duplicates folded — every
      submitted request is still served exactly once);
    * quarantined replicas get probes instead of grants and rejoin with
      neutralized node weights.

    Not supported: steal-band node schedules and router continuation
    (``router=`` reuse) — both raise in the ``simulate_cluster``
    front-end before dispatching here.
    """
    cfg = resilience if resilience is not None else ResilienceConfig()
    spec = TwoLevelSpec.parse(schedule)
    if bool(spec.node.meta.stealing):
        raise ValueError("resilience is not supported with steal-band "
                         "node schedules")
    W = int(workers_per_replica)
    evs = list(events)
    cap = _event_capacity(evs, num_replicas)
    _validate_events(evs, num_replicas, cap)
    speed_in = (np.ones(num_replicas) if replica_speed is None
                else np.asarray(replica_speed, dtype=np.float64))
    if speed_in.shape != (num_replicas,):
        raise ValueError(
            f"replica_speed must have shape ({num_replicas},), "
            f"got {speed_in.shape}")
    speed = np.ones(cap)
    speed[:num_replicas] = speed_in

    router = ClusterRouter(num_replicas, schedule=spec.node)
    router._ensure_capacity(cap)
    # requests enter the router at their *arrival* time (not all
    # upfront): chunks never contain not-yet-arrived requests, so the
    # grant-age watchdog has no irreducible arrival wait to discount
    # and backlog-sized early chunks don't swallow the whole stream
    reqs_sorted = sorted(requests, key=lambda r: (r.arrival, r.rid))
    busy0 = router.replica_busy.copy()
    requests0 = router.replica_requests.copy()
    chunks0 = router.node_chunks

    req_by_rid = {r.rid: r for r in requests}
    arrivals = {r.rid: r.arrival for r in requests}
    n_unique = len(req_by_rid)
    # exactly-once machinery: first completion per rid wins, every later
    # copy folds as a counted duplicate or is dropped stale at issue time
    committed: dict[int, tuple[float, int]] = {}
    copies = {r.rid: 1 for r in requests}     # live copies per rid
    hedges: dict[int, int] = {}               # hedge count per rid
    done: list[tuple[Request, float, int, float]] = []

    health = HealthTracker(cap, cfg, base_speed=speed)
    alive = [rep < num_replicas for rep in range(cap)]
    killed = [False] * cap
    epoch = [0] * cap      # bumped on kill/scale-down: stales pulls
    q_epoch = [0] * cap    # bumped on (un)quarantine: stales probes
    queued = [False] * cap
    inflight: list[Optional[_Chunk]] = [None] * cap
    free_time = [0.0] * cap
    probe_gap = [cfg.deadline_floor] * cap

    stats_n = dict(reclaimed=0, duplicates=0, quarantines=0, probes=0,
                   probe_successes=0, false_reclaims=0, cancelled_chunks=0,
                   deadline_misses=0, restarts=0, stale_drops=0)
    wasted_busy = 0.0
    reclaims_by_replica = [0] * cap
    reclaim_log: list[ReclaimGrant] = []

    (PRIO_EVENT, PRIO_ARRIVE, PRIO_FOLD, PRIO_DEADLINE, PRIO_PROBE,
     PRIO_PULL) = range(6)
    # heap entries: (time, priority, replica-or-event-index, stamp).
    # Fold/deadline stamps come from a global counter matched against the
    # chunk (re-simulation retires the old entries); pull stamps are the
    # replica epoch; probe stamps the quarantine epoch.
    stamp_counter = 0
    heap: list[tuple[float, int, int, int]] = [
        (float(ev.time), PRIO_EVENT, idx, -1) for idx, ev in enumerate(evs)]
    arr_idx = 0
    while (arr_idx < len(reqs_sorted)
           and reqs_sorted[arr_idx].arrival <= 0.0):
        router.submit(reqs_sorted[arr_idx])
        arr_idx += 1
    if arr_idx < len(reqs_sorted):
        heap.append((float(reqs_sorted[arr_idx].arrival), PRIO_ARRIVE, 0, -1))
    for rep in range(num_replicas):
        heap.append((0.0, PRIO_PULL, rep, 0))
        queued[rep] = True
    heapq.heapify(heap)

    def next_stamp() -> int:
        nonlocal stamp_counter
        stamp_counter += 1
        return stamp_counter

    def active_ids() -> list[int]:
        return [r for r in range(cap)
                if alive[r] and health.state[r] != QUARANTINED]

    def wake(rep: int, t: float) -> None:
        if (alive[rep] and not queued[rep] and inflight[rep] is None
                and health.state[rep] != QUARANTINED):
            queued[rep] = True
            heapq.heappush(heap, (max(float(t), free_time[rep]),
                                  PRIO_PULL, rep, epoch[rep]))

    def wake_all(t: float) -> None:
        for r in range(cap):
            wake(r, t)

    def run_segment(reqs: list, rep: int, t: float) -> dict:
        # a fresh intra-node scheduler per segment: restart semantics —
        # intra-replica adaptive state is not worth carrying across the
        # interruption points resilience introduces
        return simulate_serving(
            list(reqs), num_workers=W,
            scheduler=RequestScheduler(num_workers=W, technique=spec.thread),
            worker_speed=np.full(W, float(speed[rep])),
            worker_free_at=np.full(W, float(t)),
            return_completions=True)

    def fold_rid(rid: int, fin: float, rep: int, service: float) -> None:
        nonlocal wasted_busy
        copies[rid] = copies.get(rid, 1) - 1
        if rid in committed:
            stats_n["duplicates"] += 1
            wasted_busy += float(service)
        else:
            committed[rid] = (float(fin), rep)
            done.append((req_by_rid[rid], float(fin), rep, float(service)))

    def issue(rep: int, reqs: list, t: float, probe: bool = False) -> None:
        seg = run_segment(reqs, rep, t)
        cost_seg = math.fsum(r.cost for r in reqs)
        last_arrival = max(r.arrival for r in reqs)
        wait = max(0.0, float(last_arrival) - t)
        finish = float(np.max(seg["worker_finish"]))
        # the segment's unit-speed duration: what this work *should*
        # take on a nominal replica — a property of the work (its costs
        # and packing), recovered by normalizing out the segment speed
        span = max((finish - t) / max(float(speed[rep]), 1e-12), 1e-12)
        if probe:
            allowed = wait + max(
                cfg.deadline_floor,
                cfg.probe_k * health.healthy_slowness(active_ids()) * span)
        else:
            allowed = health.allowed_span(rep, span, wait)
        ch = _Chunk(rep=rep, start=t, seg_start=t, speed=float(speed[rep]),
                    reqs=list(reqs), completions=list(seg["completions"]),
                    finish=finish,
                    busy=float(np.sum(seg["worker_busy"])),
                    allowed=allowed, cost_seg=cost_seg, span=span,
                    probe=probe)
        inflight[rep] = ch
        ch.fold_stamp = next_stamp()
        heapq.heappush(heap, (ch.finish, PRIO_FOLD, rep, ch.fold_stamp))
        ch.deadline_stamp = next_stamp()
        heapq.heappush(heap, (ch.start + ch.allowed, PRIO_DEADLINE, rep,
                              ch.deadline_stamp))

    def hedge_rids(ch: _Chunk, t: float) -> None:
        issued = 0
        for req in ch.reqs:
            rid = req.rid
            if rid in committed or rid in ch.hedged:
                continue
            if hedges.get(rid, 0) >= cfg.max_hedges:
                continue
            hedges[rid] = hedges.get(rid, 0) + 1
            ch.hedged[rid] = hedges[rid]
            copies[rid] = copies.get(rid, 0) + 1
            # the hedged copy cannot be served before now: clamp its
            # arrival (latency still measures from the original arrival)
            router.submit(dataclasses.replace(
                req, arrival=max(req.arrival, float(t))))
            reclaim_log.append(ReclaimGrant(time=float(t), rid=rid,
                                            victim=ch.rep,
                                            attempt=hedges[rid]))
            stats_n["reclaimed"] += 1
            reclaims_by_replica[ch.rep] += 1
            issued += 1
        if issued:
            wake_all(t)

    def quarantine(rep: int, t: float) -> None:
        act = active_ids()
        if rep not in act:
            return
        if len(act) <= 1:
            # never quarantine the last active replica: keep it serving
            # (demoted to suspect) rather than deadlock the cluster
            health.state[rep] = SUSPECT
            return
        health.state[rep] = QUARANTINED
        stats_n["quarantines"] += 1
        q_epoch[rep] += 1
        queued[rep] = False
        router.set_active([r for r in act if r != rep])
        probe_gap[rep] = cfg.deadline_floor
        heapq.heappush(heap, (float(t) + probe_gap[rep], PRIO_PROBE, rep,
                              q_epoch[rep]))
        probe_gap[rep] *= cfg.probe_backoff
        wake_all(t)

    def rejoin(rep: int, t: float) -> None:
        health.reset(rep)
        q_epoch[rep] += 1
        probe_gap[rep] = cfg.deadline_floor
        router.set_active(active_ids())
        router.neutralize(rep)
        wake(rep, t)

    def finalize(ch: _Chunk, t: float) -> None:
        """Fold the chunk's segment completions and report its busy."""
        rep = ch.rep
        for rid, fin in ch.completions:
            fold_rid(rid, fin, rep, req_by_rid[rid].cost * ch.speed)
        busy_total = ch.reported_busy + ch.busy
        if busy_total > 0.0:
            router.complete(rep, busy=busy_total)
        inflight[rep] = None
        free_time[rep] = float(t)

    def interrupt(ch: _Chunk, t: float) -> None:
        """A mid-chunk speed change: completions before ``t`` stand, the
        remainder restarts at the new speed (partial in-flight work is
        discarded — the re-prefill semantics of a real engine)."""
        rep = ch.rep
        folded_service = 0.0
        for rid, fin in ch.completions:
            if fin <= t:
                svc = req_by_rid[rid].cost * ch.speed
                fold_rid(rid, fin, rep, svc)
                folded_service += svc
        ch.reported_busy += folded_service
        remaining = [req for req in ch.reqs if req.rid not in committed]
        if not remaining:
            if ch.reported_busy > 0.0:
                router.complete(rep, busy=ch.reported_busy)
            inflight[rep] = None
            free_time[rep] = float(t)
            wake(rep, t)
            return
        stats_n["restarts"] += 1
        seg = run_segment(remaining, rep, t)
        ch.reqs = remaining
        ch.seg_start = float(t)
        ch.speed = float(speed[rep])
        ch.cost_seg = math.fsum(r.cost for r in remaining)
        ch.completions = list(seg["completions"])
        ch.busy = float(np.sum(seg["worker_busy"]))
        ch.finish = float(np.max(seg["worker_finish"]))
        ch.span = max((ch.finish - float(t))
                      / max(float(speed[rep]), 1e-12), 1e-12)
        # the original deadline stays armed: the watchdog does not know
        # the cause of the slowdown, only the grant's age
        ch.fold_stamp = next_stamp()
        heapq.heappush(heap, (ch.finish, PRIO_FOLD, rep, ch.fold_stamp))

    def drop_chunk(ch: _Chunk, t: float) -> None:
        """Kill/scale-down: completions before ``t`` stand, unserved
        requests requeue, the chunk dies with the replica."""
        rep = ch.rep
        folded_service = 0.0
        for rid, fin in ch.completions:
            if fin <= t:
                svc = req_by_rid[rid].cost * ch.speed
                fold_rid(rid, fin, rep, svc)
                folded_service += svc
        busy_total = ch.reported_busy + folded_service
        if busy_total > 0.0:
            router.complete(rep, busy=busy_total)
        lost = [req for req in ch.reqs if req.rid not in committed]
        for req in lost:
            router.submit(dataclasses.replace(
                req, arrival=max(req.arrival, float(t))))
        inflight[rep] = None

    def cancel_redundant(t: float) -> None:
        """Cut loose in-flight chunks whose every request was already
        served elsewhere — the replica frees now instead of finishing
        provably-wasted work (probes excepted: their verdict matters)."""
        for rep in range(cap):
            ch = inflight[rep]
            if ch is None or ch.probe:
                continue
            redundant = True
            for req in ch.reqs:
                if req.rid not in committed:
                    redundant = False
                    break
            if not redundant:
                continue
            folded_service = 0.0
            for rid, fin in ch.completions:
                if fin <= t:
                    svc = req_by_rid[rid].cost * ch.speed
                    fold_rid(rid, fin, rep, svc)
                    folded_service += svc
            for req in ch.reqs:
                # copies that never completed evaporate with the chunk
                if req.rid not in {rid for rid, fin in ch.completions
                                   if fin <= t}:
                    copies[req.rid] = copies.get(req.rid, 1) - 1
            busy_total = ch.reported_busy + folded_service
            if busy_total > 0.0:
                router.complete(rep, busy=busy_total)
            stats_n["cancelled_chunks"] += 1
            inflight[rep] = None
            free_time[rep] = float(t)
            if ch.misses > 0 and ch.span > 0.0:
                # the chunk died overdue: its current segment held the
                # replica for (t - seg_start) without finishing, so
                # implied slowness is at least elapsed / unit-speed
                # duration — a censored observation (the true value is
                # higher, and it never exceeds the true slowness since
                # the fold would have fired at slowness x span).
                # Without it a straggler whose every chunk is hedged
                # away and cancelled would never be *observed* degraded
                # and could dodge the breaker forever.
                obs = (float(t) - ch.seg_start) / ch.span
                verdict = health.observe(
                    rep, max(obs, float(health.slowness[rep])))
                if (verdict == QUARANTINED
                        and health.state[rep] != QUARANTINED):
                    quarantine(rep, t)
            if health.state[rep] != QUARANTINED:
                wake(rep, t)

    def take_uncommitted() -> Optional[Request]:
        while True:
            req = router.take_one()
            if req is None:
                return None
            if req.rid in committed:
                stats_n["stale_drops"] += 1
                copies[req.rid] = copies.get(req.rid, 1) - 1
                continue
            return req

    while heap:
        t, prio, key, st = heapq.heappop(heap)
        if prio == PRIO_EVENT:
            ev = evs[key]
            if isinstance(ev, ReplicaSpeed):
                speed[ev.replica] = float(ev.speed)
                ch = inflight[ev.replica]
                if ch is not None and alive[ev.replica]:
                    interrupt(ch, t)
                    cancel_redundant(t)
            elif isinstance(ev, ReplicaKill):
                rep = ev.replica
                ch = inflight[rep]
                if ch is not None:
                    drop_chunk(ch, t)
                    free_time[rep] = float(t)
                else:
                    free_time[rep] = min(free_time[rep], float(t))
                alive[rep] = False
                killed[rep] = True
                epoch[rep] += 1
                q_epoch[rep] += 1
                queued[rep] = False
                health.on_kill(rep)
                router.set_active(active_ids())
                wake_all(t)
                cancel_redundant(t)
            elif isinstance(ev, ReplicaRecover):
                rep = ev.replica
                if ev.speed is not None:
                    speed[rep] = float(ev.speed)
                alive[rep] = True
                killed[rep] = False
                free_time[rep] = float(t)
                if health.crashes[rep] >= cfg.crash_loop_threshold:
                    # crash loop: rejoin on probation — quarantined until
                    # a probe succeeds
                    health.reset(rep, slowness=float(speed[rep]))
                    health.state[rep] = QUARANTINED
                    stats_n["quarantines"] += 1
                    q_epoch[rep] += 1
                    probe_gap[rep] = cfg.deadline_floor
                    heapq.heappush(heap, (float(t) + probe_gap[rep],
                                          PRIO_PROBE, rep, q_epoch[rep]))
                    probe_gap[rep] *= cfg.probe_backoff
                else:
                    health.reset(rep, slowness=float(speed[rep]))
                    router.set_active(active_ids())
                    router.neutralize(rep)
                    wake(rep, t)
            elif isinstance(ev, ScaleTo):
                m = int(ev.num_replicas)
                changed = False
                for r in range(cap):
                    if r >= m and alive[r]:
                        ch2 = inflight[r]
                        if ch2 is not None:
                            drop_chunk(ch2, t)
                        free_time[r] = float(t)
                        alive[r] = False
                        epoch[r] += 1
                        q_epoch[r] += 1
                        queued[r] = False
                        changed = True
                    elif r < m and not alive[r] and not killed[r]:
                        alive[r] = True
                        free_time[r] = float(t)
                        health.reset(r, slowness=float(speed[r]))
                        changed = True
                if changed:
                    router.set_active(active_ids())
                    wake_all(t)
                    cancel_redundant(t)
            continue

        if prio == PRIO_ARRIVE:
            while (arr_idx < len(reqs_sorted)
                   and reqs_sorted[arr_idx].arrival <= t):
                router.submit(reqs_sorted[arr_idx])
                arr_idx += 1
            if arr_idx < len(reqs_sorted):
                heapq.heappush(heap, (float(reqs_sorted[arr_idx].arrival),
                                      PRIO_ARRIVE, 0, -1))
            wake_all(t)
            continue

        rep = key
        if prio == PRIO_FOLD:
            ch = inflight[rep]
            if ch is None or ch.fold_stamp != st:
                continue
            was_quarantined = health.state[rep] == QUARANTINED
            cost_seg = ch.cost_seg
            finalize(ch, t)
            if ch.probe:
                obs = ch.busy / max(cost_seg, 1e-12)
                health.observe(rep, obs)
                if was_quarantined and not ch.probe_failed:
                    stats_n["probe_successes"] += 1
                    rejoin(rep, t)
                elif was_quarantined and len(committed) < n_unique:
                    heapq.heappush(heap, (float(t) + probe_gap[rep],
                                          PRIO_PROBE, rep, q_epoch[rep]))
                    probe_gap[rep] *= cfg.probe_backoff
            else:
                obs = ch.busy / max(cost_seg, 1e-12)
                verdict = health.observe(rep, obs)
                if ch.hedged:
                    victim_won = True
                    for rid in ch.hedged:
                        if committed[rid][1] != rep:
                            victim_won = False
                            break
                    if victim_won:
                        stats_n["false_reclaims"] += 1
                        health.relax(rep)
                if verdict == QUARANTINED and not was_quarantined:
                    quarantine(rep, t)
            if alive[rep] and health.state[rep] != QUARANTINED:
                wake(rep, t)
            cancel_redundant(t)
            continue

        if prio == PRIO_DEADLINE:
            ch = inflight[rep]
            if ch is None or ch.deadline_stamp != st:
                continue
            stats_n["deadline_misses"] += 1
            ch.misses += 1
            if ch.probe:
                ch.probe_failed = True
                hedge_rids(ch, t)
                # next probe is scheduled when this one folds
                continue
            verdict = health.on_miss(rep)
            hedge_rids(ch, t)
            ch.allowed *= cfg.backoff
            ch.deadline_stamp = next_stamp()
            heapq.heappush(heap, (float(t) + ch.allowed, PRIO_DEADLINE, rep,
                                  ch.deadline_stamp))
            if verdict == QUARANTINED and health.state[rep] != QUARANTINED:
                quarantine(rep, t)
            continue

        if prio == PRIO_PROBE:
            if (st != q_epoch[rep] or not alive[rep]
                    or health.state[rep] != QUARANTINED):
                continue
            if len(committed) >= n_unique:
                continue  # everything served: the breaker stays open
            if inflight[rep] is not None:
                heapq.heappush(heap, (float(t) + probe_gap[rep], PRIO_PROBE,
                                      rep, q_epoch[rep]))
                probe_gap[rep] *= cfg.probe_backoff
                continue
            req = take_uncommitted()
            if req is None:
                heapq.heappush(heap, (float(t) + probe_gap[rep], PRIO_PROBE,
                                      rep, q_epoch[rep]))
                probe_gap[rep] *= cfg.probe_backoff
                continue
            stats_n["probes"] += 1
            router.replica_requests[rep] += 1
            router.node_chunks += 1
            issue(rep, [req], max(float(t), free_time[rep]), probe=True)
            continue

        # PRIO_PULL
        if st != epoch[rep] or not alive[rep]:
            continue
        queued[rep] = False
        if health.state[rep] == QUARANTINED or inflight[rep] is not None:
            continue
        kept: list = []
        while not kept:
            chunk = router.pull(rep)
            if not chunk:
                break
            dropped = 0
            seen: dict[int, bool] = {}
            for req in chunk:
                if req.rid in committed or req.rid in seen:
                    dropped += 1
                    copies[req.rid] = copies.get(req.rid, 1) - 1
                    stats_n["stale_drops"] += 1
                else:
                    seen[req.rid] = True
                    kept.append(req)
            if dropped:
                # stale copies never reached a slot: keep the telemetry
                # honest about what the replica actually served
                router.replica_requests[rep] -= dropped
        if not kept:
            continue  # backlog empty: the replica retires (events re-wake)
        issue(rep, kept, max(float(t), free_time[rep]))

    # -- stats ---------------------------------------------------------------
    free_at = np.array(free_time)
    slot_busy = (router.replica_busy - busy0) / W
    if done:
        lat = np.array([fin - arrivals[req.rid] for req, fin, _, _ in done])
        order = sorted(range(len(done)),
                       key=lambda i: (done[i][1], done[i][0].rid))
        req_arrival = np.array([arrivals[done[i][0].rid] for i in order])
        req_finish = np.array([done[i][1] for i in order])
    else:
        lat = None
        req_arrival = req_finish = None
    record = ClusterRecord(
        schedule=spec, num_replicas=cap,
        workers_per_replica=W, n=len(done),
        makespan=float(free_at.max()),
        replica_busy=slot_busy,
        replica_finish=free_at,
        replica_requests=router.replica_requests - requests0,
        node_chunks=router.node_chunks - chunks0,
        request_arrival=req_arrival,
        request_finish=req_finish)
    if recorder is not None:
        recorder.add(record.to_record(loop, recorder.next_instance(loop)))

    weights = router.node_weights
    out = dict(
        n=len(done),
        makespan=record.makespan,
        replica_busy=slot_busy.tolist(),
        replica_finish=free_at.tolist(),
        replica_requests=record.replica_requests.tolist(),
        node_chunks=record.node_chunks,
        cross_node_cov=record.cov,
        cross_node_pi=record.percent_imbalance,
        node_technique=str(spec.node),
        thread_technique=str(spec.thread),
        node_weights=None if weights is None else weights.tolist(),
        migrated_requests=None,
        resilience=dict(
            reclaimed_requests=stats_n["reclaimed"],
            duplicate_completions=stats_n["duplicates"],
            wasted_busy=float(wasted_busy),
            quarantines=stats_n["quarantines"],
            probes=stats_n["probes"],
            probe_successes=stats_n["probe_successes"],
            false_reclaims=stats_n["false_reclaims"],
            cancelled_chunks=stats_n["cancelled_chunks"],
            deadline_misses=stats_n["deadline_misses"],
            restarts=stats_n["restarts"],
            stale_drops=stats_n["stale_drops"],
            health=list(health.state),
            slowness=health.slowness.tolist(),
            reclaims_by_replica=list(reclaims_by_replica),
            reclaims=[dataclasses.asdict(g) for g in reclaim_log],
        ),
    )
    if lat is None:
        out.update(mean_latency=0.0, p50=0.0, p99=0.0, p999=0.0)
    else:
        out.update(mean_latency=float(lat.mean()),
                   p50=float(np.percentile(lat, 50)),
                   p99=float(np.percentile(lat, 99)),
                   p999=float(np.percentile(lat, 99.9)))
    if return_completions:
        out["completions"] = [(req.rid, fin) for req, fin, _, _ in done]
        out["latencies"] = ([] if req_finish is None
                            else (req_finish - req_arrival).tolist())
    return out
