"""Continuous-batching serving scheduler driven by DLS self-scheduling.

A copy of ``src/repro/serve/scheduler.py`` for the PyTorch port (NumPy; the
reference module loads JAX through ``repro.core``).

The serving queue is the paper's loop: requests are *iterations* with
irregular cost (prompt length + requested tokens), decode slots are
*workers*.  Admission uses the chunk calculus — a freed worker grabs a
DLS-sized chunk of requests instead of one (SS) or a fixed batch
(STATIC); AF/AWF weighting adapts to measured slot throughput, which is
how heterogeneous replicas (or replicas degraded by long contexts) get
less work.

Two layers:
  * `RequestScheduler` — host-side DLS admission over an arrival queue
    (any technique from repro.core; default FAC2).
  * `DecodeEngine` (``serve/engine.py``) — batched decode loop over slot
    states with prefill-on-admit; integrates with models.decode_step.

The scheduler's simulated-latency mode is `simulate_serving`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from ..core.schedule import ScheduleSpec, resolve

__all__ = ["Request", "RequestScheduler", "simulate_serving"]


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    max_new_tokens: int

    @property
    def cost(self) -> float:
        # prefill ~ quadratic-ish in prompt, decode linear in new tokens
        return 1e-6 * self.prompt_len + 1e-4 * self.max_new_tokens


@dataclasses.dataclass
class RequestScheduler:
    """DLS admission: workers pull chunks of the pending queue.

    ``technique`` accepts a ScheduleSpec or an OMP_SCHEDULE-style string
    (``"runtime"`` / None reads $LB_SCHEDULE, default fac2); an explicit
    ``chunk_param`` argument overrides the spec's.
    """

    num_workers: int
    technique: Union[ScheduleSpec, str, None] = "fac2"
    chunk_param: Optional[int] = None

    def __post_init__(self):
        self.spec = resolve(self.technique, default="fac2",
                            chunk_param=self.chunk_param)
        # backlog = _pending[_head:]: pulls advance the head cursor in
        # O(chunk) instead of copying the remaining queue per pull; the
        # consumed prefix is compacted away amortized-O(1) per request
        self._pending: list[Request] = []
        self._head = 0
        self._tech = None
        # set by serve.elastic.resize_scheduler: the carried-over tech is
        # sized for the *old* worker count, so the next pull must re-plan
        # (and inherit) even though the old plan still has work remaining
        self._force_replan = False
        self._plan_gen = 0  # admission-plan generation (a "time-step")
        self._assigned: dict[int, list[Request]] = {
            w: [] for w in range(self.num_workers)}
        # per-worker outstanding grant awaiting complete()
        self._outstanding: dict[int, object] = {}
        # workers whose inherited adaptive state must be neutralized at
        # the next plan rebuild (circuit-breaker rejoin: the replica's
        # pre-quarantine telemetry described a degraded machine)
        self._neutralize: dict[int, bool] = {}

    def submit(self, req: Request) -> None:
        self._pending.append(req)

    def _new_tech(self):
        """Re-plan over the current backlog, carrying adaptive state
        (AWF/AF weights and telemetry) over from the previous plan.  Each
        plan is a new execution instance (time-step): begin_instance lets
        timestep-cadence techniques (plain AWF) fold the inherited
        telemetry window into their weights."""
        tech = self.spec.make(n=self.backlog, p=self.num_workers)
        if self._tech is not None:
            tech.inherit(self._tech)
        if self._neutralize:
            # deferred import: elastic imports this module at top level
            from .elastic import neutralize_worker_state
            neutralize_worker_state(tech, sorted(self._neutralize))
            self._neutralize.clear()
        self._plan_gen += 1
        tech.begin_instance(self._plan_gen)
        return tech

    def pull(self, worker: int) -> list[Request]:
        """A freed worker requests its next chunk of requests.

        Guaranteed to make progress: while the backlog is non-empty this
        returns at least one request (the admission plan is rebuilt over
        the refreshed backlog whenever the previous one drains), so an
        empty result means an empty backlog.  An empty pull does *not*
        reset the technique: adaptive state survives idle gaps (and keeps
        receiving late complete() reports) until the next plan inherits
        it.

        A worker pulling twice without an intervening ``complete()`` folds
        the grants: the outstanding grant grows by the new take, so the
        eventual measurement — which by construction covers the service
        time of *both* chunks — is attributed to the combined size instead
        of silently dropping the first chunk from the telemetry.
        """
        if self._head >= len(self._pending):
            return []
        if (self._tech is None or self._force_replan
                or self._tech.remaining <= 0):
            # also covers the backlog having drained mid-plan: granted
            # sizes are clamped to the backlog, so an emptied queue
            # implies remaining <= 0 and the next pull re-plans here
            self._tech = self._new_tech()
            self._force_replan = False
        grant = self._tech.next_chunk(worker)
        take = min(grant.size, self.backlog)
        head = self._head
        out = self._pending[head:head + take]
        self._head = head + take
        if self._head >= len(self._pending):
            self._pending.clear()
            self._head = 0
        elif self._head >= 512 and self._head * 2 >= len(self._pending):
            # compact once the dead prefix dominates: each request is
            # moved at most a constant number of times over its lifetime
            del self._pending[:self._head]
            self._head = 0
        self._assigned[worker].extend(out)
        prev = self._outstanding.get(worker)
        if prev is None:
            self._outstanding[worker] = dataclasses.replace(grant, size=take)
        else:
            self._outstanding[worker] = dataclasses.replace(
                prev, size=prev.size + take)
        return out

    def complete(self, worker: int, elapsed: float) -> None:
        """Report the measured service time of the worker's last chunk.

        This is the path that makes the adaptive techniques adaptive at
        the serving layer: AF/AWF weighting folds ``elapsed`` (any
        monotone unit — seconds, decode steps) per granted request into
        its per-slot throughput estimate, so heterogeneous or degraded
        replicas get smaller admission chunks on subsequent pulls.

        The measurement feeds the *current* plan's technique: a chunk
        still in flight when another worker triggered a re-plan would
        otherwise report into the superseded (already-inherited-from)
        instance and be lost — adaptive state flows forward, so late
        completions must too.
        """
        grant = self._outstanding.pop(worker, None)
        if grant is None or self._tech is None:
            return
        self._tech.complete_chunk(worker, grant, float(elapsed))

    def take_front(self, k: int) -> list[Request]:
        """Pop up to ``k`` requests off the backlog front, bypassing the
        admission technique.

        The probe path of the resilience layer: a quarantined replica is
        not granted chunks, but its circuit-breaker probe still needs a
        real request.  No grant is opened — the caller must not
        ``complete()`` for this take — and the current plan is left as
        is: granted sizes are clamped to the live backlog at pull time,
        so the plan simply runs out ``k`` requests earlier.
        """
        if k <= 0 or self._head >= len(self._pending):
            return []
        head = self._head
        out = self._pending[head:head + k]
        self._head = head + len(out)
        if self._head >= len(self._pending):
            self._pending.clear()
            self._head = 0
        return out

    def drop(self, pred) -> list[Request]:
        """Remove every pending request matching ``pred``; return them.

        The admission-shedding hook (``DecodeEngine`` deadline-aware
        shedding): dropped requests were never granted, so no technique
        or telemetry state needs repair — the next plan rebuild simply
        sees the smaller backlog.
        """
        keep: list[Request] = []
        dropped: list[Request] = []
        for req in self._pending[self._head:]:
            if pred(req):
                dropped.append(req)
            else:
                keep.append(req)
        if dropped:
            self._pending = keep
            self._head = 0
        return dropped

    def neutralize_worker(self, worker: int) -> None:
        """Mark ``worker``'s adaptive state for neutralization at the
        next plan rebuild (after ``inherit`` runs) — the rejoin path of
        the circuit breaker.  See ``elastic.neutralize_worker_state``.
        """
        w = int(worker)
        if not 0 <= w < self.num_workers:
            raise ValueError(f"worker {w} out of range "
                             f"[0, {self.num_workers})")
        self._neutralize[w] = True

    @property
    def backlog(self) -> int:
        return len(self._pending) - self._head


def simulate_serving(requests: list[Request], num_workers: int,
                     technique: Union[ScheduleSpec, str] = "fac2",
                     chunk_param: Optional[int] = None,
                     worker_speed: Optional[np.ndarray] = None,
                     worker_free_at: Optional[np.ndarray] = None,
                     scheduler: Optional[RequestScheduler] = None,
                     return_completions: bool = False) -> dict:
    """Event-driven serving simulation: returns latency stats.

    Workers process their assigned chunk sequentially (a chunk == one
    continuous batch refill).  The reference uses it to reproduce the
    paper's load-balance findings at the serving layer and as the
    per-replica lower level of ``simulate_cluster``.

    ``worker_busy`` is *service* time per worker (cost x speed of the
    requests it served in this call); idle time waiting for an arrival is
    excluded — both from the stats and from the ``complete()``
    measurement fed to adaptive techniques, so a worker that merely
    waited on a sparse arrival stream is not mistaken for a slow one.
    ``worker_finish`` has the raw finish timestamps (busy + idle).

    Continuation hooks (how the cluster layer runs one replica across
    many node-level chunks):

      * ``worker_free_at`` — initial worker clocks; the simulation runs
        in absolute time from there (arrivals keep their frame);
      * ``scheduler`` — an existing ``RequestScheduler`` to reuse, so
        intra-node adaptive state (AWF/AF weights) persists across
        calls; ``technique``/``chunk_param`` are ignored when given;
      * ``drain_time`` in the stats — the timestamp at which the backlog
        emptied (the last admission pull), i.e. when a replica would
        request its next node-sized chunk;
      * ``return_completions=True`` adds ``completions``: ``(rid,
        finish_time)`` per served request.

    An empty request list returns a well-defined all-zero stats dict
    (same keys) instead of NaN-propagating through ``mean``/``percentile``.
    """
    if scheduler is not None and scheduler.num_workers != num_workers:
        raise ValueError(f"scheduler has {scheduler.num_workers} workers, "
                         f"expected {num_workers}")
    sched = scheduler if scheduler is not None else RequestScheduler(
        num_workers=num_workers, technique=technique,
        chunk_param=chunk_param)
    speed = np.ones(num_workers) if worker_speed is None else worker_speed
    for r in sorted(requests, key=lambda r: r.arrival):
        sched.submit(r)
    free_at = (np.zeros(num_workers) if worker_free_at is None
               else np.asarray(worker_free_at, dtype=np.float64).copy())
    start_at = free_at.copy()
    busy = np.zeros(num_workers)
    drain_time = float(free_at.min())
    done: list[tuple[Request, float]] = []
    # all requests pre-arrived (batch regime): workers repeatedly pull.
    # pull() drains the backlog to empty (it re-plans internally), so an
    # empty chunk terminates the loop — no spin on a non-empty backlog.
    while True:
        w = int(np.argmin(free_at))
        chunk = sched.pull(w)
        if not chunk:
            break
        if sched.backlog == 0:
            drain_time = float(free_at[w])
        t = free_at[w]
        chunk_busy = 0.0
        for r in chunk:
            service = r.cost * speed[w]
            t = max(t, r.arrival) + service
            chunk_busy += service
            done.append((r, t))
        # busy time only: t - free_at[w] would also count idle waiting
        # for r.arrival, making waits look like slow service and shrinking
        # the worker's AWF/AF chunks for no reason
        sched.complete(w, elapsed=chunk_busy)
        busy[w] += chunk_busy
        free_at[w] = t
    if not done:
        out = dict(n=0, makespan=float(free_at.max()), mean_latency=0.0,
                   p50=0.0, p99=0.0, worker_busy=busy.tolist(),
                   worker_finish=free_at.tolist(), imbalance=0.0,
                   drain_time=drain_time)
        if return_completions:
            out["completions"] = []
        return out
    lat = np.array([t - r.arrival for r, t in done])
    span = float(free_at.max() - start_at.min())
    out = dict(
        n=len(done),
        makespan=float(free_at.max()),
        mean_latency=float(lat.mean()),
        p50=float(np.percentile(lat, 50)),
        p99=float(np.percentile(lat, 99)),
        worker_busy=busy.tolist(),
        worker_finish=free_at.tolist(),
        imbalance=float((free_at.max() - free_at.mean())
                        / max(span, 1e-9)),
        drain_time=drain_time,
    )
    if return_completions:
        out["completions"] = [(r.rid, t) for r, t in done]
    return out
