"""Two-level cluster load balancing: node-level DLS over replica engines.

The paper's cross-node result — and the two-level scheme of Mohammed et
al., "Two-level Dynamic Load Balancing for High Performance Scientific
Applications" (arXiv:1911.06714) — composes two schedulers:

  * an **upper (node) level** that hands *node-sized chunks* of the
    arrival stream to replicas (a replica "pull" is one continuous-batch
    refill for a whole node), using any registry technique: SS/GSS/FAC2
    for work-stealing-style dynamics, AWF/AF for weights that *learn*
    heterogeneous or degraded replicas from measured replica busy time;
  * each replica's existing **intra-node level** — the
    ``RequestScheduler``/``DecodeEngine`` admission technique over its
    decode slots.

The pair is a :class:`TwoLevelSpec` (``node_schedule`` x
``thread_schedule``), mirroring the MPI-rank x OpenMP-thread split of
the source work.  ``simulate_cluster`` is the event-driven two-level
simulator (it reuses :func:`simulate_serving` per replica chunk);
``cluster_grid``/``simulate_cluster_batch`` run (node-technique x
thread-technique x traffic) config grids in the ``batch_sim`` idiom
(shared-scenario dedup, one result dict per grid point) for the
reference's ``benchmarks/cluster_balance.py``.  Cross-node imbalance
aggregates per-replica *busy* times through the paper's Table-1 metrics
(``cov`` / ``percent_imbalance``), and every cluster run can feed a
:class:`ClusterRecord` into a ``LoopRecorder``.

A copy of ``src/repro/serve/cluster.py`` for the PyTorch port.  Like
``serve/scheduler.py`` this module is numpy-only — the torch replica
engines bind to it in ``launch/serve.py:run_cluster``, which runs the
replicas one after another on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import numpy as np

from ..core.metrics import LoopInstanceRecord, LoopRecorder, cov, percent_imbalance
from ..core.schedule import ScheduleSpec, resolve
from .elastic import resize_scheduler
from .scheduler import Request, RequestScheduler, simulate_serving

__all__ = [
    "TwoLevelSpec",
    "ClusterRouter",
    "ClusterRecord",
    "ClusterEvent",
    "ReplicaKill",
    "ReplicaRecover",
    "ReplicaSpeed",
    "ScaleTo",
    "simulate_cluster",
    "ClusterConfig",
    "cluster_grid",
    "simulate_cluster_batch",
    "make_traffic",
]


# ---------------------------------------------------------------------------
# Fault / elasticity events (the scenario programs of repro_torch.trials)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    """Base of the mid-stream perturbations ``simulate_cluster`` injects.

    Events fire at absolute simulation time ``time``; an event tied with
    a replica pull at the same instant is applied first, so the pull
    sees the post-event cluster.  Subclass, don't instantiate.
    """

    time: float


@dataclasses.dataclass(frozen=True)
class ReplicaKill(ClusterEvent):
    """Replica ``replica`` crashes at ``time``.

    In-flight requests (completion timestamps after the kill) are lost
    and resubmitted to the router — they will be served again by a
    survivor, with latency measured from their *original* arrival.  The
    node scheduler re-plans over the survivors via
    ``ClusterRouter.set_active`` (``Technique.inherit`` carries AWF/AF/
    BOLD state); the dead replica's intra-node state is discarded.
    """

    replica: int


@dataclasses.dataclass(frozen=True)
class ReplicaRecover(ClusterEvent):
    """A previously killed replica rejoins at ``time``.

    It comes back with fresh worker clocks and a *fresh* intra-node
    scheduler — intra-replica adaptive state does not survive a crash;
    only the node level's (carried across the membership change by
    ``Technique.inherit``) does.  ``speed`` optionally sets a new cost
    multiplier for the reborn replica (e.g. a cold cache: slower).
    """

    replica: int
    speed: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ReplicaSpeed(ClusterEvent):
    """Thermal/degradation event: set replica ``replica``'s cost
    multiplier to ``speed`` (>1 == slower) at ``time``.

    Replica chunks are served atomically, so the new speed applies from
    the replica's *next* node-level pull — a static node technique that
    bound all its work up front never feels a later degradation, which
    is exactly the blind spot the thermal trial scenarios probe.  The
    resilience layer (``serve/resilience.py``, enabled with
    ``simulate_cluster(..., resilience=...)``) closes it: there a speed
    event *interrupts* the in-flight chunk and overdue grants are
    reclaimed to healthy replicas.
    """

    replica: int
    speed: float


@dataclasses.dataclass(frozen=True)
class ScaleTo(ClusterEvent):
    """Elasticity event: resize the active set to replicas ``[0,
    num_replicas)`` at ``time``.

    Scale-up activates dormant replicas (never-started ids; ids downed
    by an explicit :class:`ReplicaKill` stay dead until their
    :class:`ReplicaRecover`) with fresh clocks and intra-node state.
    Scale-down is preemptive: replicas outside the new set stop
    immediately and their in-flight requests are requeued, like a kill.
    Both re-plan the node level over the new membership with inherited
    adaptive state.
    """

    num_replicas: int


def _event_capacity(evs: Sequence[ClusterEvent], num_replicas: int) -> int:
    """The largest replica id any event can touch (array capacity)."""
    cap = num_replicas
    for ev in evs:
        if isinstance(ev, ScaleTo):
            cap = max(cap, int(ev.num_replicas))
        elif isinstance(ev, (ReplicaKill, ReplicaRecover, ReplicaSpeed)):
            cap = max(cap, int(ev.replica) + 1)
        else:
            raise TypeError(f"unknown cluster event {ev!r}")
    return cap


def _validate_events(evs: Sequence[ClusterEvent], num_replicas: int,
                     cap: int) -> None:
    """Reject incoherent event programs up front.

    A ``ReplicaKill`` of an already-dead replica and a
    ``ReplicaRecover`` of a never-killed one used to flow through the
    heap silently (the kill was skipped, the recover activated whatever
    was down) — masking scenario-authoring bugs.  Replays the program in
    time order (stable in program order at ties, matching the heap) over
    an alive/killed model and raises a ``ValueError`` naming the replica
    and time on the first contradiction.
    """
    alive = [r < num_replicas for r in range(cap)]
    down = [False] * cap  # killed and not yet recovered
    for ev in sorted(evs, key=lambda e: float(e.time)):
        if isinstance(ev, ReplicaKill):
            r = int(ev.replica)
            if down[r]:
                raise ValueError(
                    f"duplicate ReplicaKill for replica {r} at "
                    f"t={ev.time}: replica is already dead")
            if not alive[r]:
                raise ValueError(
                    f"ReplicaKill for replica {r} at t={ev.time}: "
                    f"replica is not active (dormant or scaled down)")
            alive[r] = False
            down[r] = True
        elif isinstance(ev, ReplicaRecover):
            r = int(ev.replica)
            if not down[r]:
                raise ValueError(
                    f"ReplicaRecover for replica {r} at t={ev.time}: "
                    f"replica was never killed")
            down[r] = False
            alive[r] = True
        elif isinstance(ev, ScaleTo):
            m = int(ev.num_replicas)
            for r in range(cap):
                if r >= m:
                    alive[r] = False
                elif not down[r]:
                    alive[r] = True


@dataclasses.dataclass(frozen=True)
class TwoLevelSpec:
    """The two-level schedule pair: node-level x thread-level.

    Text form is ``"node_spec/thread_spec"`` with each side the usual
    ``OMP_SCHEDULE`` grammar, e.g. ``"awf_b/fac2,8"`` (AWF-B across
    replicas, FAC2 with chunk floor 8 across each replica's slots).
    A bare ``"gss"`` means GSS at the node level with the default FAC2
    below it.
    """

    node: ScheduleSpec
    thread: ScheduleSpec

    @classmethod
    def parse(cls, text: "str | TwoLevelSpec | ScheduleSpec",
              default_thread: "str | ScheduleSpec" = "fac2") -> "TwoLevelSpec":
        if isinstance(text, TwoLevelSpec):
            return text
        if isinstance(text, ScheduleSpec):
            return cls(node=text.validated(), thread=resolve(default_thread))
        node_txt, _, thread_txt = str(text).partition("/")
        return cls(node=resolve(node_txt),
                   thread=resolve(thread_txt or None, default=default_thread))

    def __str__(self) -> str:
        return f"{self.node}/{self.thread}"


class ClusterRouter:
    """Node-level DLS admission: replicas pull node-sized request chunks.

    Wraps a :class:`RequestScheduler` whose "workers" are replicas, so
    the full registry applies unchanged at the node level — including
    plan-rebuild-with-inherited-state over a refreshed backlog and the
    grant-folding/busy-time telemetry contracts.  ``complete(replica,
    busy)`` reports the replica's measured *busy* time for its last
    chunk (sum of per-slot service time, or decode steps on a real
    engine — any monotone unit), which is what lets AWF/AF node weights
    converge toward replica speed ratios under heterogeneity.

    A *steal-band* node schedule (``TechniqueSpec.stealing``, e.g.
    ``"ws_rr,4/fac2"``) switches the router to replica-to-replica request
    migration — node-level work stealing, the missing half of the
    arXiv:1911.06714 two-level design.  Each planning wave freezes the
    backlog into a snapshot partitioned across per-replica deques; a
    replica's pull pops requests pre-assigned to *it*, and once its deque
    drains the steal protocol serves it requests originally assigned to a
    busier replica — ``migrated_requests`` counts those.  Steal
    techniques are non-adaptive, so ``complete`` measurements update the
    telemetry counters only.
    """

    def __init__(self, num_replicas: int,
                 schedule: Union[ScheduleSpec, str, None] = "awf_b",
                 chunk_param: Optional[int] = None):
        if num_replicas <= 0:
            raise ValueError(f"need num_replicas > 0, got {num_replicas}")
        self.num_replicas = num_replicas
        spec = resolve(schedule, default="fac2", chunk_param=chunk_param)
        self._steal = bool(spec.meta.stealing)
        if self._steal:
            self.sched = None
            self.spec = spec
            self._pending: list[Request] = []
            self._snapshot: list[Request] = []
            self._stech = None
            self._plan_gen = 0
            self.migrated_requests = 0
        else:
            self.sched = RequestScheduler(num_workers=num_replicas,
                                          technique=spec)
            self.spec = self.sched.spec
        # the live membership: global replica id -> scheduler-local index.
        # Fault/elasticity events shrink or grow it via set_active; the
        # identity mapping is the no-events fast path.
        self._active_ids = list(range(num_replicas))
        self._local = {r: r for r in range(num_replicas)}
        # per-replica cumulative telemetry (the ClusterRecord inputs);
        # num_replicas is the *capacity* — scale events can grow it
        self.replica_busy = np.zeros(num_replicas)
        self.replica_requests = np.zeros(num_replicas, dtype=np.int64)
        self.node_chunks = 0

    def submit(self, req: Request) -> None:
        if self._steal:
            self._pending.append(req)
        else:
            self.sched.submit(req)

    def _ensure_capacity(self, n: int) -> None:
        """Grow the telemetry arrays (and capacity) to ``n`` replicas."""
        if n <= self.num_replicas:
            return
        grow = n - self.num_replicas
        self.replica_busy = np.concatenate([self.replica_busy,
                                            np.zeros(grow)])
        self.replica_requests = np.concatenate(
            [self.replica_requests, np.zeros(grow, dtype=np.int64)])
        self.num_replicas = n

    def set_active(self, ids: Sequence[int]) -> None:
        """Change the live replica membership (fault/elasticity hook).

        The backlog and node-level adaptive state move to a scheduler
        resized over ``len(ids)`` workers (:func:`~repro_torch.serve.elastic.
        resize_scheduler`): the next pull re-plans with
        ``Technique.inherit``, so AWF/AF/BOLD telemetry survives kills,
        recoveries and scale events.  Pulls from replicas outside the
        set return empty; their ``complete`` reports still accrue to the
        telemetry arrays but no longer feed the node technique.  An
        empty ``ids`` leaves the scheduler dormant — backlog and
        adaptive state wait for the next non-empty membership.
        """
        if self._steal:
            raise ValueError("steal-band routers do not support set_active "
                             "(fault/elasticity events)")
        ids = sorted({int(i) for i in ids})
        if ids:
            self._ensure_capacity(ids[-1] + 1)
        if ids == self._active_ids:
            return
        self._active_ids = ids
        if ids:
            self.sched = resize_scheduler(self.sched, len(ids))
        self._local = {g: i for i, g in enumerate(ids)}

    def _steal_pull(self, replica: int) -> list[Request]:
        tech = self._stech
        if tech is None or tech.remaining <= 0:
            if not self._pending:
                return []
            # freeze the backlog: one steal plan per wave, grants index
            # the snapshot — request identity is preserved, so a grant
            # served off another replica's deque IS a migrated request
            self._snapshot = self._pending
            self._pending = []
            tech = self._stech = self.spec.make(
                n=len(self._snapshot), p=self.num_replicas)
            self._plan_gen += 1
            tech.begin_instance(self._plan_gen)
        g = tech.next_chunk(replica)
        if getattr(g, "victim", -1) >= 0:
            self.migrated_requests += g.size
        return self._snapshot[g.start:g.start + g.size]

    def pull(self, replica: int) -> list[Request]:
        if self._steal:
            chunk = self._steal_pull(replica)
        else:
            loc = self._local.get(replica)
            chunk = [] if loc is None else self.sched.pull(loc)
        if chunk:
            self.node_chunks += 1
            self.replica_requests[replica] += len(chunk)
        return chunk

    def complete(self, replica: int, busy: float) -> None:
        self.replica_busy[replica] += float(busy)
        if not self._steal:
            loc = self._local.get(replica)
            if loc is not None:
                self.sched.complete(loc, elapsed=float(busy))

    def take_one(self) -> Optional[Request]:
        """Pop the front-most pending request, bypassing the technique.

        The circuit breaker's probe hook (``serve/resilience.py``): a
        quarantined replica is outside the active membership, so it
        cannot ``pull`` — a probe takes exactly one real request off the
        backlog instead.  No grant is opened, so the probe's measurement
        never feeds the node technique.  Returns ``None`` on an empty
        backlog.
        """
        if self._steal:
            raise ValueError("steal-band routers do not support take_one "
                             "(probe grants)")
        got = self.sched.take_front(1)
        return got[0] if got else None

    def neutralize(self, replica: int) -> None:
        """Neutralize replica ``replica``'s adaptive node weight at the
        next plan rebuild (the circuit-breaker rejoin hook).

        The replica's pre-quarantine telemetry described a degraded
        machine; a rejoin inherits node state via ``set_active`` →
        ``Technique.inherit``, so without this the healed replica would
        keep its starved weight.  No-op for replicas outside the active
        set and for non-adaptive node techniques.
        """
        if self._steal:
            return
        loc = self._local.get(replica)
        if loc is not None:
            self.sched.neutralize_worker(loc)

    @property
    def backlog(self) -> int:
        if self._steal:
            live = 0 if self._stech is None else max(0, self._stech.remaining)
            return live + len(self._pending)
        return self.sched.backlog

    @property
    def node_weights(self) -> Optional[np.ndarray]:
        """Current adaptive per-replica weights (AWF family), else None."""
        if self.sched is None:
            return None
        tech = self.sched._tech
        w = getattr(tech, "weights", None)
        return None if w is None else np.asarray(w, dtype=np.float64)


@dataclasses.dataclass
class ClusterRecord:
    """Cross-node telemetry for one cluster run — replica == "thread".

    ``to_record`` projects it onto a :class:`LoopInstanceRecord` (busy
    times as thread_times, replica finish timestamps as thread_finish,
    node-chunk count as the scheduling-round count), so cluster runs
    feed the same ``cov``/``percent_imbalance``/``LoopRecorder.summary``
    machinery as simulated loops and kernel tile plans.
    """

    schedule: TwoLevelSpec
    num_replicas: int
    workers_per_replica: int
    n: int
    makespan: float
    replica_busy: np.ndarray
    replica_finish: np.ndarray
    replica_requests: np.ndarray
    node_chunks: int
    # per-request completion timestamps, sorted by (finish, rid): the
    # raw material for latency-percentile statistics (repro_torch.trials).
    # Arrivals are the requests' original submission times — a request
    # requeued by a replica kill keeps its first arrival, so its latency
    # includes the lost work.
    request_arrival: Optional[np.ndarray] = None
    request_finish: Optional[np.ndarray] = None

    @property
    def request_latency(self) -> Optional[np.ndarray]:
        if self.request_finish is None or self.request_arrival is None:
            return None
        return self.request_finish - self.request_arrival

    @property
    def cov(self) -> float:
        return cov(self.replica_busy)

    @property
    def percent_imbalance(self) -> float:
        return percent_imbalance(self.replica_busy, self.makespan)

    def to_record(self, loop: str = "cluster",
                  instance: int = 0) -> LoopInstanceRecord:
        return LoopInstanceRecord(
            loop=loop, technique=str(self.schedule), instance=instance,
            p=self.num_replicas, n=self.n,
            chunk_param=self.schedule.node.chunk_param,
            t_par=self.makespan,
            thread_times=np.asarray(self.replica_busy, dtype=np.float64),
            thread_finish=np.asarray(self.replica_finish, dtype=np.float64),
            n_chunks=self.node_chunks, sched_time=0.0)


def simulate_cluster(requests: Sequence[Request], num_replicas: int,
                     workers_per_replica: int = 4,
                     schedule: Union[TwoLevelSpec, str] = "awf_b/fac2",
                     replica_speed: Optional[Sequence[float]] = None,
                     router: Optional[ClusterRouter] = None,
                     recorder: Optional[LoopRecorder] = None,
                     loop: str = "cluster",
                     events: Sequence[ClusterEvent] = (),
                     return_completions: bool = False,
                     resilience: Optional["object"] = None) -> dict:
    """Event-driven two-level serving simulation.

    The upper level is a :class:`ClusterRouter`: a replica pulls its
    next node-sized chunk the moment its first slot goes hungry (its
    backlog has drained and the earliest slot frees), while its other
    slots are still finishing their last admissions — so node-level
    chunks pipeline instead of barriering on the slowest slot.  Each
    chunk is served by :func:`simulate_serving` — the existing
    intra-node event simulator — continued across chunks with the
    replica's persistent worker clocks and persistent
    ``RequestScheduler`` (so intra-node AWF/AF state also survives
    refills).  The chunk's summed slot busy time is reported back to the
    router with the replica's *next* pull, exactly the
    request-more-work/report-measurement cycle ``DecodeEngine._refill``
    runs — closing the loop that lets adaptive node techniques learn
    replica throughput.

    Replica pulls are processed in global time order (an event heap on
    drain times), so the router's shared-queue state sees the same pull
    sequence a real cluster would.

    ``replica_speed`` are cost multipliers per replica (>1 == slower),
    matching ``simulate_serving``'s ``worker_speed`` convention.  Stats
    mirror ``simulate_serving`` plus cross-node aggregates (per-replica
    busy is reported *per slot* — ``busy / workers_per_replica`` — so it
    is comparable with the makespan in ``percent_imbalance``); pass a
    ``recorder`` to append a :class:`ClusterRecord` projection.  Pass a
    ``router`` to continue a previous call's node-level state (wave-by-
    wave serving: AWF node weights learned on one wave carry to the
    next); telemetry in the result is always this call's delta.

    ``events`` injects mid-stream perturbations — :class:`ReplicaKill`,
    :class:`ReplicaRecover`, :class:`ReplicaSpeed`, :class:`ScaleTo` —
    through the same event heap that orders replica pulls, so a fault at
    time *t* is applied between the pull before and the pull after *t*.
    A kill rewinds the victim's post-*t* completions (the requests it
    had in flight) back into the router's backlog; every submitted
    request is still served exactly once, with latency measured from its
    original arrival.  Membership changes re-plan the node level over
    the survivors via :meth:`ClusterRouter.set_active` (adaptive state
    carried by ``Technique.inherit``).  ``ScaleTo`` events may grow the
    cluster past ``num_replicas``; the ``replica_*`` result arrays then
    cover the grown capacity.  Steal-band node schedules do not support
    events.  Incoherent event programs (killing an already-dead replica,
    recovering a never-killed one) raise ``ValueError`` up front.

    ``resilience`` switches on the failure-response layer (straggler
    deadlines, chunk reclamation with hedged re-execution, circuit-
    breaker quarantine — see ``serve/resilience.py``): pass a
    ``ResilienceConfig`` to dispatch to
    :func:`~repro_torch.serve.resilience.simulate_cluster_resilient`, whose
    physics close this module's chunk-atomicity blind spot (a mid-chunk
    ``ReplicaSpeed`` event interrupts the chunk there instead of waiting
    for the next pull).  With ``resilience=None`` (the default) this
    function's behavior — and every digest downstream — is unchanged.
    """
    import heapq

    if resilience is not None:
        if router is not None:
            raise ValueError("resilience does not support router "
                             "continuation (router=...)")
        from .resilience import simulate_cluster_resilient
        return simulate_cluster_resilient(
            requests, num_replicas,
            workers_per_replica=workers_per_replica, schedule=schedule,
            replica_speed=replica_speed, recorder=recorder, loop=loop,
            events=events, return_completions=return_completions,
            resilience=resilience)

    spec = TwoLevelSpec.parse(schedule)
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
    if router is None:
        router = ClusterRouter(num_replicas, schedule=spec.node)
    elif router.num_replicas != num_replicas:
        raise ValueError(f"router has {router.num_replicas} replicas, "
                         f"expected {num_replicas}")
    elif router.spec != spec.node:
        # a reused router keeps its own node technique; a mismatched
        # schedule would mislabel every record and stat downstream
        raise ValueError(f"router schedules {router.spec}, but the "
                         f"requested node schedule is {spec.node}")
    if evs and router._steal:
        raise ValueError("fault/elasticity events are not supported with "
                         "steal-band node schedules")
    router._ensure_capacity(cap)
    for r in sorted(requests, key=lambda r: r.arrival):
        router.submit(r)
    # snapshot router telemetry so a reused router (wave-by-wave serving
    # with persistent node-level adaptive state) reports per-call deltas
    busy0 = router.replica_busy.copy()
    requests0 = router.replica_requests.copy()
    chunks0 = router.node_chunks
    migrated0 = getattr(router, "migrated_requests", 0)
    clocks = [np.zeros(workers_per_replica) for _ in range(cap)]
    intra = [RequestScheduler(num_workers=workers_per_replica,
                              technique=spec.thread)
             for _ in range(cap)]
    pending_busy = [0.0] * cap  # last chunk's busy, not yet reported
    # (request, finish, replica, service): replica + service support the
    # kill-event rewind; completions/latency read request.rid + finish
    done: list[tuple[Request, float, int, float]] = []
    arrivals = {r.rid: r.arrival for r in requests}
    alive = [rep < num_replicas for rep in range(cap)]
    killed = [False] * cap      # explicitly killed: ScaleTo won't revive
    epoch = [0] * cap           # bumped on kill: invalidates queued pulls
    queued = [False] * cap      # has a live pull entry in the heap
    # heap entries: (time, priority, key, epoch).  Priority 0 = event
    # (key = index into evs), 1 = replica pull (key = replica id) — an
    # event at time t is applied before any pull at t, and equal-time
    # pulls keep ordering by replica id.
    heap: list[tuple[float, int, int, int]] = [
        (float(ev.time), 0, idx, -1) for idx, ev in enumerate(evs)]
    for rep in range(num_replicas):
        heap.append((0.0, 1, rep, 0))
        queued[rep] = True
    heapq.heapify(heap)

    def wake(rep: int, t: float) -> None:
        # (re)schedule a pull for a live replica with no queued entry —
        # retirees re-enter service when an event adds backlog/capacity
        if alive[rep] and not queued[rep]:
            queued[rep] = True
            heapq.heappush(heap, (max(float(t), float(clocks[rep].min())),
                                  1, rep, epoch[rep]))

    def activate(rep: int, t: float) -> None:
        alive[rep] = True
        killed[rep] = False
        clocks[rep] = np.full(workers_per_replica, float(t))
        # intra-node adaptive state does not survive a crash/cold start;
        # only node-level state does (via set_active -> inherit)
        intra[rep] = RequestScheduler(num_workers=workers_per_replica,
                                      technique=spec.thread)

    def deactivate(rep: int, t: float) -> None:
        # rewind this replica's post-t completions: those requests were
        # in flight when it died, and must be served again elsewhere
        lost = [e for e in done if e[2] == rep and e[1] > t]
        if lost:
            done[:] = [e for e in done if not (e[2] == rep and e[1] > t)]
            # retract the lost requests' service time from telemetry —
            # first from the unreported chunk, remainder from the
            # already-accrued busy (never below this call's baseline)
            extra = sum(e[3] for e in lost)
            take = min(pending_busy[rep], extra)
            pending_busy[rep] -= take
            rem = extra - take
            if rem > 0:
                router.replica_busy[rep] = max(
                    float(busy0[rep]), float(router.replica_busy[rep]) - rem)
            router.replica_requests[rep] -= len(lost)
            for req, _, _, _ in lost:
                # requeued copies cannot be served before the kill: clamp
                # the copy's arrival to t (latency still uses the
                # original arrival via the `arrivals` map)
                router.submit(dataclasses.replace(
                    req, arrival=max(req.arrival, float(t))))
        if pending_busy[rep]:
            # the surviving part of the last chunk's measurement still
            # feeds the node technique before the membership re-plan
            router.complete(rep, busy=pending_busy[rep])
            pending_busy[rep] = 0.0
        clocks[rep] = np.minimum(clocks[rep], float(t))
        alive[rep] = False
        queued[rep] = False
        epoch[rep] += 1

    while heap:
        t, prio, key, stamp = heapq.heappop(heap)
        if prio == 0:
            ev = evs[key]
            if isinstance(ev, ReplicaSpeed):
                # chunk-atomic: applies from the replica's next pull
                speed[ev.replica] = float(ev.speed)
            elif isinstance(ev, ReplicaKill):
                if alive[ev.replica]:
                    deactivate(ev.replica, t)
                    killed[ev.replica] = True
                    router.set_active(
                        [r for r in range(cap) if alive[r]])
                    for r2 in range(cap):  # requeued work re-wakes retirees
                        wake(r2, t)
            elif isinstance(ev, ReplicaRecover):
                if ev.speed is not None:
                    speed[ev.replica] = float(ev.speed)
                if not alive[ev.replica]:
                    activate(ev.replica, t)
                    router.set_active(
                        [r for r in range(cap) if alive[r]])
                    wake(ev.replica, t)
            elif isinstance(ev, ScaleTo):
                m = int(ev.num_replicas)
                changed = False
                for r in range(cap):
                    if r >= m and alive[r]:
                        deactivate(r, t)  # preemptive: in-flight requeued
                        changed = True
                    elif r < m and not alive[r] and not killed[r]:
                        activate(r, t)
                        changed = True
                if changed:
                    router.set_active(
                        [r for r in range(cap) if alive[r]])
                    for r2 in range(cap):
                        wake(r2, t)
            continue
        rep = key
        if stamp != epoch[rep] or not alive[rep]:
            continue  # stale pull queued before a kill
        queued[rep] = False
        if pending_busy[rep]:
            router.complete(rep, busy=pending_busy[rep])
            pending_busy[rep] = 0.0
        chunk = router.pull(rep)
        if not chunk:
            continue  # backlog empty: the replica retires (events re-wake)
        stats = simulate_serving(
            chunk, num_workers=workers_per_replica, scheduler=intra[rep],
            worker_speed=np.full(workers_per_replica, speed[rep]),
            worker_free_at=clocks[rep], return_completions=True)
        clocks[rep] = np.asarray(stats["worker_finish"])
        pending_busy[rep] = float(np.sum(stats["worker_busy"]))
        by_rid = {r.rid: r for r in chunk}
        for rid, fin in stats["completions"]:
            req = by_rid[rid]
            done.append((req, fin, rep, req.cost * float(speed[rep])))
        # the replica requests its next node chunk when its first slot
        # goes hungry (min finish), not when the backlog merely drained:
        # one slow slot must not stall the refill for the idle ones
        queued[rep] = True
        heapq.heappush(heap, (float(clocks[rep].min()), 1, rep, epoch[rep]))

    # flush the final chunks' measurements (no further pull will report
    # them) so node-level adaptive state is complete for a reused router
    for rep in range(cap):
        if pending_busy[rep]:
            router.complete(rep, busy=pending_busy[rep])

    free_at = np.array([c.max() for c in clocks])
    # per-slot busy (raw sum / W): comparable with the makespan, so the
    # Table-1 metrics read as usual — a replica at busy == makespan was
    # never idle
    slot_busy = (router.replica_busy - busy0) / workers_per_replica
    if done:
        lat = np.array([fin - arrivals[req.rid] for req, fin, _, _ in done])
        # sorted by (finish, rid): a canonical per-request timeline for
        # the trial statistics layer
        order = sorted(range(len(done)),
                       key=lambda i: (done[i][1], done[i][0].rid))
        req_arrival = np.array([arrivals[done[i][0].rid] for i in order])
        req_finish = np.array([done[i][1] for i in order])
    else:
        lat = None
        req_arrival = req_finish = None
    record = ClusterRecord(
        schedule=spec, num_replicas=cap,
        workers_per_replica=workers_per_replica, n=len(done),
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
        # steal-band node level only: requests served off another
        # replica's deque this call (None == self-scheduling node level)
        migrated_requests=(
            router.migrated_requests - migrated0 if router._steal else None),
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


# ---------------------------------------------------------------------------
# Config grids (the batch_sim idiom at the cluster level)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ClusterConfig:
    """One grid point: everything ``simulate_cluster`` takes, as data."""

    schedule: Union[TwoLevelSpec, str]
    requests: Sequence[Request]
    num_replicas: int = 8
    workers_per_replica: int = 4
    replica_speed: Optional[Sequence[float]] = None
    traffic: str = ""


def cluster_grid(
    schedules: Sequence[Union[TwoLevelSpec, str]],
    traffics: Mapping[str, Sequence[Request]],
    **common,
) -> list[ClusterConfig]:
    """Cartesian (schedule x traffic) grid, traffic-major like
    ``batch_grid`` — configs sharing a request stream stay adjacent."""
    return [
        ClusterConfig(schedule=s, requests=reqs, traffic=name, **common)
        for name, reqs in traffics.items()
        for s in schedules
    ]


def simulate_cluster_batch(configs: Sequence[ClusterConfig],
                           recorder: Optional[LoopRecorder] = None) -> list[dict]:
    """Run a config grid; one result dict per config, in order.

    Provably-identical grid points (same resolved two-level spec, same
    request stream object, same shape/speeds) are simulated once and the
    result shared — the same dedup ``simulate_batch`` applies across its
    repetition-seed axis (the simulator is deterministic, so equal
    configs have equal results).
    """
    cache: dict[tuple, dict] = {}
    out = []
    for c in configs:
        spec = TwoLevelSpec.parse(c.schedule)
        speed = (None if c.replica_speed is None
                 else tuple(float(s) for s in c.replica_speed))
        key = (str(spec), id(c.requests), c.num_replicas,
               c.workers_per_replica, speed)
        if key not in cache:
            cache[key] = simulate_cluster(
                c.requests, num_replicas=c.num_replicas,
                workers_per_replica=c.workers_per_replica, schedule=spec,
                replica_speed=c.replica_speed, recorder=recorder,
                loop=f"cluster/{c.traffic}" if c.traffic else "cluster")
        out.append(dict(cache[key], traffic=c.traffic))
    return out


# ---------------------------------------------------------------------------
# Synthetic traffic (the skew axis of the cluster campaign)
# ---------------------------------------------------------------------------


def make_traffic(kind: str, n: int = 800, seed: int = 0) -> list[Request]:
    """Synthetic arrival streams for the cluster campaign.

      uniform     identical requests, all pre-arrived (the control where
                  static replica partitioning is already balanced)
      heavy_tail  lognormal decode lengths — regime-sensitive skew: when
                  a drawn giant costs on the order of the ideal makespan
                  (it happens at these parameters, depending on n and
                  seed), the critical path is one indivisible request
                  and static's accidental early binding can win; with
                  milder draws dynamic wins as usual.  Kept un-gated in
                  the campaign for exactly that honesty.
      spiky       96% small requests + ~4% giants (hot-request skew —
                  many giants, so spreading them across replicas pays)
      zipf        Zipf-distributed decode lengths (power-law skew)
      bursty      spiky sizes arriving in bursts (skew + waves; eager
                  node chunks bind not-yet-arrived requests, so small
                  node chunks win)
      diurnal     arrivals follow one sinusoidal "day" (rate ∝
                  1 − A·cos(2πt/T) over [0, T], inverse-CDF sampled):
                  a quiet trough, a loaded peak — the daily ramp a
                  static partition provisions wrong at both ends
      flash_crowd background trickle with ~35% of all requests landing
                  inside a 0.02-wide spike at a seeded moment (the
                  "everyone hits reload" regime)
    """
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return [Request(rid=i, arrival=0.0, prompt_len=512,
                        max_new_tokens=128) for i in range(n)]
    if kind == "heavy_tail":
        return [Request(rid=i, arrival=0.0,
                        prompt_len=int(rng.lognormal(6, 1)),
                        max_new_tokens=int(rng.lognormal(4.5, 1.2)))
                for i in range(n)]
    if kind == "spiky":
        new = rng.integers(16, 64, size=n).astype(np.int64)
        giants = rng.choice(n, size=max(1, n // 25), replace=False)
        new[giants] = rng.integers(4096, 8192, size=giants.size)
        return [Request(rid=i, arrival=0.0,
                        prompt_len=int(rng.integers(64, 1024)),
                        max_new_tokens=int(new[i])) for i in range(n)]
    if kind == "zipf":
        new = np.minimum(16 * rng.zipf(1.4, size=n), 8192)
        return [Request(rid=i, arrival=0.0,
                        prompt_len=int(rng.integers(64, 1024)),
                        max_new_tokens=int(new[i])) for i in range(n)]
    if kind == "bursty":
        new = rng.integers(16, 64, size=n).astype(np.int64)
        giants = rng.choice(n, size=max(1, n // 25), replace=False)
        new[giants] = rng.integers(4096, 8192, size=giants.size)
        burst_t = np.sort(rng.uniform(0.0, 0.5, size=max(1, n // 100)))
        which = rng.integers(0, burst_t.size, size=n)
        return [Request(rid=i, arrival=float(burst_t[which[i]]),
                        prompt_len=int(rng.integers(64, 1024)),
                        max_new_tokens=int(new[i])) for i in range(n)]
    if kind == "diurnal":
        T, A = 0.6, 0.9
        grid = np.linspace(0.0, T, 2049)
        cdf = (grid - (A * T / (2 * np.pi)) * np.sin(2 * np.pi * grid / T)) / T
        arr = np.sort(np.interp(rng.random(n), cdf, grid))
        new = rng.integers(16, 256, size=n)
        return [Request(rid=i, arrival=float(arr[i]),
                        prompt_len=int(rng.integers(64, 1024)),
                        max_new_tokens=int(new[i])) for i in range(n)]
    if kind == "flash_crowd":
        T = 0.6
        k = max(1, int(round(0.35 * n)))
        t0 = float(rng.uniform(0.1, T - 0.1))
        arr = rng.uniform(0.0, T, size=n)
        crowd = rng.choice(n, size=k, replace=False)
        arr[crowd] = t0 + rng.uniform(0.0, 0.02, size=k)
        arr = np.sort(arr)
        new = rng.integers(16, 256, size=n)
        return [Request(rid=i, arrival=float(arr[i]),
                        prompt_len=int(rng.integers(64, 1024)),
                        max_new_tokens=int(new[i])) for i in range(n)]
    raise ValueError(f"unknown traffic kind {kind!r}; known: "
                     "uniform, heavy_tail, spiky, zipf, bursty, "
                     "diurnal, flash_crowd")
