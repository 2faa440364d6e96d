"""Work-stealing scheduling band — the paradigm LB4OMP leaves out.

Every technique in `core/techniques.py` is *self-scheduling*: workers pull
chunks from one shared queue governed by a chunk calculus.  This module
implements the other half of the design space ("OpenMP Loop Scheduling
Revisited", arXiv 1809.03188; the `lb.hpp` exemplar): the iteration space
is pre-partitioned into per-worker deques, owners pop from the *front* of
their own deque with no synchronization at all, and an idle worker turns
thief — it polls victims for work and transfers iterations from the *back*
of a victim's deque.  The cost model is inverted relative to DLS: the
common case (a local pop) is free of sync, and the rare case (a steal
probe) pays ``o_steal`` per polled victim (`core/simulator.py`).

Pluggable along two axes, mirroring `lb.hpp`:

  victim policy   ``rr`` — asynchronous round-robin: worker ``i`` starts
                  probing at ``i+1`` and remembers where it left off;
                  ``rp`` — random polling, seeded per config.
  granularity     steal-*half* — the thief transfers half the victim's
                  remaining iterations to its own deque (then pops
                  locally); steal-*chunk* — the thief takes exactly one
                  ``chunk_param``-sized grain from the victim's back.

Registered variants (all resolve through ``ScheduleSpec`` / the registry,
so `simulate`, `simulate_batch`, the planner, the AutoSelector and
serving/cluster all accept them by name):

  ``ws_rr`` / ``ws_rp``      steal-half, round-robin / random victim
  ``ws_rr_c`` / ``ws_rp_c``  steal-one-chunk variants
  ``dls_steal``              hybrid (alias ``dls+steal``): a FAC2 chunk
                             plan is dealt round-robin onto the worker
                             deques — decreasing-size chunks give a
                             balanced *initial* assignment — and stealing
                             only kicks in on the tail, once a worker's
                             own deque drains.

The initial equal split uses ``np.linspace(0, n, p + 1)`` — byte-identical
to the simulator's ccNUMA ``owner_bounds`` — so under a NUMA penalty an
owner's local pops are remote-free and exactly the *stolen* iterations pay
the locality cost, which is the textbook trade-off stealing makes.

Grants are :class:`StealGrant`: a ``ChunkGrant`` carrying the number of
victim probes (``steal_attempts``, charged ``o_steal`` each by both
simulators) and the victim id.  Chunk ``start`` positions are *not*
contiguous in grant order — `core/planner.py` validates coverage on the
start-sorted sequence, and the batch engine's lockstep band asks the
per-lane state machines for positions instead of assuming a shared-queue
cursor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .schedule import (
    ScheduleSpec,
    TechniqueSpec,
    bind_step_batch,
    register_technique,
)
from .techniques import ChunkGrant, Technique

__all__ = [
    "StealGrant",
    "WSRoundRobin",
    "WSRandom",
    "WSRoundRobinChunk",
    "WSRandomChunk",
    "DLSSteal",
    "STEAL_TECHNIQUES",
]


@dataclasses.dataclass(frozen=True)
class StealGrant(ChunkGrant):
    """A chunk grant annotated with steal telemetry.

    ``steal_attempts`` counts victim probes made to satisfy this grant
    (0 == local pop); the simulators charge ``o_steal`` per probe.
    ``victim`` is the deque the work came from (-1 == the worker's own).
    """

    steal_attempts: int = 0
    victim: int = -1


class _StealBase(Technique):
    """Per-worker deque state machine behind every ``ws_*`` variant.

    Deques hold ``[lo, hi)`` iteration segments; owners pop from the
    front, thieves take from the back (the classic owner/thief split).
    The shared-queue bookkeeping of the base class (``scheduled``,
    ``request_idx``) is maintained so telemetry and termination behave
    like any other technique, but ``next_chunk`` is overridden wholesale:
    grant *positions* come from the deques, not a global cursor.
    """

    policy = "rr"  # "rr" | "rp"
    steal_mode = "half"  # "half" | "chunk"
    whole_segments = False  # hybrid: local pops take whole planned chunks

    def _init(self, **kw) -> None:
        del kw
        self._reset_deques()

    def _on_begin_instance(self) -> None:
        # fresh iteration space each instance; the RP rng (if any) is
        # seeded once in _init and persists, like RAND
        self._reset_deques()

    def _reset_deques(self) -> None:
        self._deques: List[List[List[int]]] = [[] for _ in range(self.p)]
        # ARR per lb.hpp: worker i's first probe targets i+1 and the
        # cursor persists across its own steals (and across requests)
        self._next_victim = [(w + 1) % self.p for w in range(self.p)]
        self._seed_deques()

    def _seed_deques(self) -> None:
        bounds = np.linspace(0, self.n, self.p + 1).astype(np.int64)
        for w in range(self.p):
            lo, hi = int(bounds[w]), int(bounds[w + 1])
            if hi > lo:
                self._deques[w].append([lo, hi])

    # -- deque primitives ----------------------------------------------------
    def _pop_local(self, worker: int) -> Tuple[int, int]:
        seg = self._deques[worker][0]
        lo, hi = seg
        take = (hi - lo) if self.whole_segments else min(
            self.chunk_param, hi - lo)
        seg[0] = lo + take
        if seg[0] >= seg[1]:
            self._deques[worker].pop(0)
        return lo, take

    def _find_victim(self, thief: int) -> Tuple[int, int]:
        """Probe until a non-empty deque turns up; every probe counts one
        ``o_steal``.  Only called when ``remaining > 0`` with an empty own
        deque, so some other deque is non-empty and the search terminates
        (and p >= 2 necessarily holds)."""
        attempts = 0
        if self.policy == "rr":
            v = self._next_victim[thief]
            while True:
                if v == thief:
                    v = (v + 1) % self.p
                    continue
                attempts += 1
                if self._deques[v]:
                    self._next_victim[thief] = (v + 1) % self.p
                    return v, attempts
                v = (v + 1) % self.p
        while True:  # rp: uniform over the p-1 other workers
            r = int(self._rng.integers(self.p - 1))
            v = r + (r >= thief)
            attempts += 1
            if self._deques[v]:
                return v, attempts

    def _transfer_half(self, thief: int, victim: int) -> None:
        """Move ceil(half) of the victim's remaining iterations, taken
        from the *back* of its deque, onto the thief's (empty) deque."""
        dq = self._deques[victim]
        # integer iteration bounds: order-exact  # lint: disable=DET004
        target = (sum(hi - lo for lo, hi in dq) + 1) // 2
        stolen: List[List[int]] = []
        got = 0
        while got < target:
            lo, hi = dq[-1]
            size = hi - lo
            if got + size <= target:
                dq.pop()
                stolen.append([lo, hi])
                got += size
            else:
                take = target - got
                dq[-1][1] = hi - take  # victim keeps the front
                stolen.append([hi - take, hi])
                got = target
        stolen.reverse()  # lowest-position segment first for the thief
        self._deques[thief] = stolen

    def _steal_one(self, thief: int, victim: int) -> Tuple[int, int]:
        """Take a single grain directly off the victim's back."""
        del thief
        dq = self._deques[victim]
        lo, hi = dq[-1]
        take = (hi - lo) if self.whole_segments else min(
            self.chunk_param, hi - lo)
        dq[-1][1] = hi - take
        if dq[-1][0] >= dq[-1][1]:
            dq.pop()
        return hi - take, take

    # -- Technique interface -------------------------------------------------
    def next_chunk(self, worker: int) -> Optional[StealGrant]:
        if self.remaining <= 0:
            return None
        attempts, victim = 0, -1
        if self._deques[worker]:
            lo, size = self._pop_local(worker)
        else:
            victim, attempts = self._find_victim(worker)
            if self.steal_mode == "half":
                self._transfer_half(worker, victim)
                lo, size = self._pop_local(worker)
            else:
                lo, size = self._steal_one(worker, victim)
        grant = StealGrant(start=lo, size=size, batch=self.request_idx,
                           worker=worker, steal_attempts=attempts,
                           victim=victim)
        self.scheduled += size
        self.request_idx += 1
        self._after_grant(grant)
        return grant


@register_technique
class WSRoundRobin(_StealBase):
    """ws_rr — steal-half with asynchronous round-robin victim polling."""

    spec = TechniqueSpec("ws_rr", False, False, "none", 1.0,
                         worker_dependent=True, chunk_exact=True,
                         stealing=True)
    policy = "rr"
    steal_mode = "half"


@register_technique
class WSRandom(_StealBase):
    """ws_rp — steal-half with seeded random victim polling."""

    spec = TechniqueSpec("ws_rp", False, False, "none", 1.0,
                         worker_dependent=True, chunk_exact=True,
                         stealing=True)
    policy = "rp"
    steal_mode = "half"

    def _init(self, seed: int = 0, **kw) -> None:
        self._rng = np.random.default_rng(seed)
        super()._init(**kw)


@register_technique
class WSRoundRobinChunk(WSRoundRobin):
    """ws_rr_c — steal exactly one chunk_param grain per steal."""

    spec = TechniqueSpec("ws_rr_c", False, False, "none", 1.0,
                         worker_dependent=True, chunk_exact=True,
                         stealing=True)
    steal_mode = "chunk"


@register_technique
class WSRandomChunk(WSRandom):
    """ws_rp_c — random-victim steal-one-chunk."""

    spec = TechniqueSpec("ws_rp_c", False, False, "none", 1.0,
                         worker_dependent=True, chunk_exact=True,
                         stealing=True)
    steal_mode = "chunk"


@register_technique
class DLSSteal(_StealBase):
    """dls_steal (alias ``dls+steal``) — DLS plan first, stealing on the tail.

    A FAC2 chunk sequence over (n, p) is dealt round-robin onto the
    worker deques: the factoring family's decreasing chunk sizes give
    each worker a balanced, mostly-large initial assignment, computed
    once with zero runtime synchronization.  Owners pop whole planned
    chunks; only when a worker's deque runs dry does the steal-half
    protocol redistribute the (small-chunked, by construction) tail.
    ``chunk_param`` is FAC2's lower-bound threshold, as usual.
    """

    spec = TechniqueSpec("dls_steal", False, False, "none", 1.0,
                         worker_dependent=True, stealing=True)
    policy = "rr"
    steal_mode = "half"
    whole_segments = True
    INNER = "fac2"

    def _seed_deques(self) -> None:
        inner = ScheduleSpec(self.INNER, chunk_param=self.chunk_param).make(
            n=self.n, p=self.p)
        i = 0
        while True:
            g = inner.next_chunk(i % self.p)
            if g is None:
                break
            self._deques[i % self.p].append([g.start, g.start + g.size])
            i += 1


#: registered steal-family names, in registration order
STEAL_TECHNIQUES = ("ws_rr", "ws_rp", "ws_rr_c", "ws_rp_c", "dls_steal")


# ---------------------------------------------------------------------------
# Lockstep-band machines (core/batch_sim.py)
# ---------------------------------------------------------------------------


class _BatchSteal:
    """Steal-aware lockstep machine: L lanes of one ``ws_*`` technique.

    Unlike :class:`~repro_torch.core.techniques.BatchTechnique` machines, which
    return chunk *sizes* against the engine's shared-queue cursor, a steal
    machine owns per-lane deque state and returns chunk *positions* too —
    plus the probe counts the engine converts to ``o_steal`` time.  Lanes
    wrap real host instances, so batch == event agreement is exact by
    construction; the engine still vectorizes the clock/NUMA/cost
    arithmetic across lanes (`_run_lockstep_band`).
    """

    def __init__(self, host_cls, n, p, chunk_param, kws):
        self.techs = [host_cls(n=int(ni), p=int(p), chunk_param=int(cpi),
                               **kw)
                      for ni, cpi, kw in zip(n, chunk_param, kws)]
        self._last: dict = {}

    def begin_instance(self, instance: int, act) -> None:
        for li in act:
            self.techs[int(li)].begin_instance(instance)

    def pops(self, act, workers):
        """Advance each active lane one grant; returns (starts, sizes,
        steal_attempts, victims) int64 arrays aligned with ``act``."""
        m = len(act)
        starts = np.empty(m, np.int64)
        sizes = np.empty(m, np.int64)
        attempts = np.empty(m, np.int64)
        victims = np.empty(m, np.int64)
        for j in range(m):
            li = int(act[j])
            g = self.techs[li].next_chunk(int(workers[j]))
            self._last[li] = g
            starts[j], sizes[j] = g.start, g.size
            attempts[j], victims[j] = g.steal_attempts, g.victim
        return starts, sizes, attempts, victims

    def complete(self, act, workers, sizes, exec_t, sched_t) -> None:
        del sizes
        for j, li in enumerate(act):
            g = self._last.pop(int(li), None)
            if g is not None:
                self.techs[int(li)].complete_chunk(
                    int(workers[j]), g, float(exec_t[j]), float(sched_t[j]))

    def end_instance(self, act) -> None:
        for li in act:
            self.techs[int(li)].end_instance()


def _bind(name: str, cls) -> None:
    def factory(n, p, chunk_param, kws, _cls=cls):
        return _BatchSteal(_cls, n, p, chunk_param, kws)

    bind_step_batch(name, factory)


for _name, _cls in (("ws_rr", WSRoundRobin), ("ws_rp", WSRandom),
                    ("ws_rr_c", WSRoundRobinChunk),
                    ("ws_rp_c", WSRandomChunk), ("dls_steal", DLSSteal)):
    _bind(_name, _cls)
