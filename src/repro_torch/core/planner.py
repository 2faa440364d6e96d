"""Host-side schedule planner — the bridge from the paper's chunk calculus
to SPMD execution (NumPy copy of ``src/repro/core/planner.py``).

Where the simulator models a live shared queue, the planner *materializes*
a schedule: a list of (worker, start, size) assignments produced by driving
the reference techniques in deterministic round-robin request order.  This
is the form consumed by the framework layers (grad-accum planning, serving
admission, MoE tile lists) and what elastic re-planning regenerates when
the worker count changes (node failure / scale-out).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .schedule import ScheduleSpec, resolve
from .techniques import Technique

__all__ = ["PlannedChunk", "Plan", "plan_schedule", "replan"]


@dataclasses.dataclass(frozen=True)
class PlannedChunk:
    worker: int
    start: int
    size: int
    batch: int


@dataclasses.dataclass(frozen=True)
class Plan:
    technique: str
    n: int
    p: int
    chunk_param: int
    chunks: tuple[PlannedChunk, ...]

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def spec(self) -> ScheduleSpec:
        """The schedule this plan materializes, as a ScheduleSpec."""
        return ScheduleSpec(self.technique, chunk_param=self.chunk_param)

    def per_worker(self) -> list[list[PlannedChunk]]:
        out: list[list[PlannedChunk]] = [[] for _ in range(self.p)]
        for c in self.chunks:
            out[c.worker].append(c)
        return out

    def worker_loads(self, costs: Optional[np.ndarray] = None) -> np.ndarray:
        """Iterations (or summed costs) per worker."""
        loads = np.zeros(self.p)
        if costs is not None:
            csum = np.concatenate([[0.0], np.cumsum(costs)])
        for c in self.chunks:
            loads[c.worker] += (
                c.size if costs is None else csum[c.start + c.size] - csum[c.start]
            )
        return loads

    def validate(self) -> None:
        """Every iteration scheduled exactly once, no gap, no overlap.

        Self-scheduling plans emit chunks in ascending-start order, but
        work-stealing plans (`core/stealing.py`) interleave positions —
        coverage is therefore checked on the start-sorted sequence, which
        is the identity permutation for every shared-queue technique.
        """
        pos = 0
        for c in sorted(self.chunks, key=lambda c: c.start):
            assert c.start == pos, f"gap/overlap at {c}"
            assert c.size >= 1
            pos += c.size
        assert pos == self.n, f"scheduled {pos} != n {self.n}"


def plan_schedule(
    technique: ScheduleSpec | str | Technique,
    n: int,
    p: int,
    chunk_param: Optional[int] = None,
    *,
    round_robin: bool = True,
    **tech_kw,
) -> Plan:
    """Materialize a full schedule under deterministic request order.

    ``technique`` is a ScheduleSpec, an OMP_SCHEDULE-style string (or
    ``"runtime"`` for $LB_SCHEDULE), or a prebuilt Technique.  Round-robin
    order is the canonical SPMD plan (worker i takes request i, p+i,
    2p+i, ...).  Adaptive techniques planned this way use only their
    current weights/stats — callers feed telemetry between plans.

    A spec with ``backend="graph"`` raises ``NotImplementedError`` in the
    port until ``torch_sched.plan_chunks`` exists (the reference
    materializes it through ``jax_sched.plan_chunks``).
    """
    if isinstance(technique, Technique):
        tech = technique
        name = tech.spec.name
        assert tech.n == n and tech.p == p
        chunk_param = tech.chunk_param
    else:
        spec = resolve(technique, chunk_param=chunk_param)
        name = spec.technique
        chunk_param = spec.chunk_param
        if spec.backend == "graph":
            return _plan_via_graph(spec, n, p, **tech_kw)
        tech = spec.make(n=n, p=p, **tech_kw)
    chunks: list[PlannedChunk] = []
    wkr = 0
    while True:
        g = tech.next_chunk(wkr if round_robin else 0)
        if g is None:
            break
        chunks.append(PlannedChunk(worker=g.worker, start=g.start,
                                   size=g.size, batch=g.batch))
        wkr = (wkr + 1) % p
    plan = Plan(technique=name, n=n, p=p,
                chunk_param=max(1, int(chunk_param)), chunks=tuple(chunks))
    plan.validate()
    return plan


def _plan_via_graph(spec: ScheduleSpec, n: int, p: int, **plan_kw) -> Plan:
    """backend="graph": the in-graph closed forms are not ported yet."""
    raise NotImplementedError(
        f"backend='graph' for {spec.technique!r} needs torch_sched.plan_chunks, "
        "which is not ported yet (ROADMAP.md, port queue item 2); use "
        "backend='host' or 'auto'")


def replan(old: Plan, new_p: int, done_iterations: int = 0, **tech_kw) -> Plan:
    """Elastic re-planning: reschedule the un-executed tail of a plan onto a
    different worker count (node failure => new_p < old.p; scale-out =>
    new_p > old.p).  The DLS techniques are self-scheduling, so this is just
    a fresh plan over the remaining iterations — the paper's adaptivity
    argument applied at pod scale."""
    rem = old.n - done_iterations
    if rem <= 0:
        return Plan(old.technique, 0, new_p, old.chunk_param, ())
    sub = plan_schedule(old.technique, rem, new_p,
                        chunk_param=old.chunk_param, **tech_kw)
    shifted = tuple(
        PlannedChunk(c.worker, c.start + done_iterations, c.size, c.batch)
        for c in sub.chunks
    )
    return Plan(old.technique, rem, new_p, old.chunk_param, shifted)
