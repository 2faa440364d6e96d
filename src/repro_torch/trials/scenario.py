"""Declarative trial scenarios: traffic x fault x elasticity programs.

A :class:`Scenario` is a frozen description of one serving condition —
what traffic arrives (a ``make_traffic`` kind or a recorded trace), on
what cluster shape, and what goes wrong mid-stream (``ClusterEvent``
programs: replica kills/recoveries, thermal degradation, scale events).
It is deliberately *data*: the executor (``repro_torch.trials.executor``)
turns a (scenario x schedule x seed) cell into a ``simulate_cluster``
run, so the same scenario replays byte-identically for every schedule
under comparison and across repeated trials.

``standard_suite`` is the benchmark suite of record (the reference's
``benchmarks/trial_bench.py``): the four original gated scenarios —
diurnal, flash_crowd, replica_failure, elastic_scale — plus four
resilience scenarios (thermal_degrade, straggler, gray_failure,
crash_loop) that run under the reclamation/quarantine physics of
``serve/resilience.py`` and are gated on dynamic-beats-static with
disjoint CIs, mirroring the perturbation/fault evaluations of the
two-level DLB study (arXiv 1911.06714).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

from ..serve.cluster import (
    ClusterEvent,
    ReplicaKill,
    ReplicaRecover,
    ReplicaSpeed,
    ScaleTo,
    make_traffic,
)
from ..serve.resilience import ResilienceConfig
from ..serve.scheduler import Request

__all__ = [
    "Scenario",
    "failure_program",
    "thermal_program",
    "elastic_program",
    "trace_from_requests",
    "requests_from_trace",
    "save_trace",
    "load_trace",
    "standard_suite",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One serving condition, as data.

    ``traffic`` names a ``make_traffic`` kind sampled per trial seed;
    a non-None ``trace`` overrides it with a fixed recorded request log
    (replayed identically for every seed — trace scenarios measure
    schedule variance only).  ``events`` is the fault/elasticity
    program, absolute-time :class:`ClusterEvent` instances applied by
    ``simulate_cluster``.  A non-None ``resilience`` switches the
    executor to the resilient serving physics
    (``serve/resilience.py``: straggler deadlines, reclamation, circuit
    breaker) — it applies to *every* schedule under comparison, so the
    matched-pairs design stays fair; ``None`` keeps the original
    physics and byte-identical digests.
    """

    name: str
    traffic: str = "uniform"
    n: int = 800
    num_replicas: int = 4
    workers_per_replica: int = 4
    replica_speed: Optional[tuple] = None
    events: tuple = ()
    trace: Optional[tuple] = None
    resilience: Optional[ResilienceConfig] = None

    def make_requests(self, seed: int) -> list[Request]:
        """The trial's request stream: traffic drawn from ``seed``, or
        the recorded trace verbatim (seed intentionally ignored)."""
        if self.trace is not None:
            return requests_from_trace(self.trace)
        return make_traffic(self.traffic, n=self.n, seed=seed)


# ---------------------------------------------------------------------------
# Event-program helpers (small vocabularies over the ClusterEvent types)
# ---------------------------------------------------------------------------


def failure_program(kill_at: float, replicas: Sequence[int],
                    recover_at: Optional[float] = None,
                    recover_speed: Optional[float] = None,
                    ) -> tuple[ClusterEvent, ...]:
    """Kill ``replicas`` at ``kill_at``; optionally recover them later."""
    evs: list[ClusterEvent] = [ReplicaKill(time=float(kill_at), replica=int(r))
                               for r in replicas]
    if recover_at is not None:
        evs += [ReplicaRecover(time=float(recover_at), replica=int(r),
                               speed=recover_speed) for r in replicas]
    return tuple(evs)


def thermal_program(replica: int, times: Sequence[float],
                    speeds: Sequence[float]) -> tuple[ClusterEvent, ...]:
    """A degradation ramp: replica's cost multiplier steps through
    ``speeds`` at ``times`` (e.g. a thermally throttling accelerator)."""
    if len(times) != len(speeds):
        raise ValueError(f"times/speeds length mismatch: "
                         f"{len(times)} vs {len(speeds)}")
    return tuple(ReplicaSpeed(time=float(t), replica=int(replica),
                              speed=float(s))
                 for t, s in zip(times, speeds))


def elastic_program(*steps: tuple[float, int]) -> tuple[ClusterEvent, ...]:
    """Scale steps ``(time, num_replicas)``, e.g. ``(0.3, 8)`` to grow
    the active set to 8 replicas at t=0.3."""
    return tuple(ScaleTo(time=float(t), num_replicas=int(m))
                 for t, m in steps)


# ---------------------------------------------------------------------------
# Trace replay (recorded request logs as the traffic program)
# ---------------------------------------------------------------------------


def trace_from_requests(requests: Sequence[Request]) -> tuple:
    """Freeze a request stream into a hashable trace tuple."""
    return tuple((int(r.rid), float(r.arrival), int(r.prompt_len),
                  int(r.max_new_tokens)) for r in requests)


def requests_from_trace(trace: Sequence) -> list[Request]:
    return [Request(rid=int(rid), arrival=float(arr), prompt_len=int(pl),
                    max_new_tokens=int(mnt))
            for rid, arr, pl, mnt in trace]


def save_trace(path: str, requests: Sequence[Request]) -> None:
    with open(path, "w") as f:
        json.dump([list(row) for row in trace_from_requests(requests)], f)


def load_trace(path: str) -> tuple:
    with open(path) as f:
        return tuple(tuple(row) for row in json.load(f))


# ---------------------------------------------------------------------------
# The suite of record
# ---------------------------------------------------------------------------


def standard_suite(quick: bool = False) -> list[Scenario]:
    """The trial-bench scenarios.

    Event times scale with ``n`` (the no-fault makespan is roughly
    linear in total request cost), so the quick suite perturbs
    mid-stream just like the full one.  The first four are the original
    gated acceptance scenarios; ``thermal_degrade`` and the three fault
    scenarios after it run under the *resilient* serving physics
    (``resilience=ResilienceConfig()``) and are gated too — reclamation
    closes the chunk-atomicity blind spot that used to keep
    thermal_degrade observational (see the reference's
    ``benchmarks/trial_bench.py``):

      thermal_degrade  gradual 2x → 4x thermal ramp on one replica
                       (below the quarantine thresholds: absorbed by
                       EWMA deadlines + adaptive node weights)
      straggler        one replica jumps 10x slower mid-stream and
                       stays there (deadline misses → reclamation →
                       quarantine)
      gray_failure     one replica degrades 25x mid-stream, then
                       silently heals (quarantine → probe → rejoin
                       with neutralized weights)
      crash_loop       one replica crashes and recovers four times
                       while the diurnal backlog is live (crash-loop
                       probation: from the second recovery on the
                       replica rejoins quarantined and must probe back
                       in; each kill strands the in-flight grant, so
                       node chunk size is what the scenario prices)
    """
    n = 300 if quick else 800
    s = n / 800.0  # event-time scale factor
    return [
        Scenario(name="diurnal", traffic="diurnal", n=n, num_replicas=4),
        Scenario(name="flash_crowd", traffic="flash_crowd", n=n,
                 num_replicas=4),
        Scenario(name="replica_failure", traffic="spiky", n=n,
                 num_replicas=4,
                 events=failure_program(kill_at=0.3 * s, replicas=(0, 1),
                                        recover_at=1.0 * s)),
        Scenario(name="elastic_scale", traffic="bursty", n=n,
                 num_replicas=4,
                 events=elastic_program((0.3 * s, 8))),
        Scenario(name="thermal_degrade", traffic="zipf", n=n,
                 num_replicas=4,
                 events=thermal_program(replica=0,
                                        times=(0.2 * s, 0.6 * s),
                                        speeds=(2.0, 4.0)),
                 resilience=ResilienceConfig()),
        Scenario(name="straggler", traffic="spiky", n=n, num_replicas=4,
                 events=thermal_program(replica=1, times=(0.25 * s,),
                                        speeds=(10.0,)),
                 resilience=ResilienceConfig()),
        Scenario(name="gray_failure", traffic="diurnal", n=n,
                 num_replicas=4,
                 events=thermal_program(replica=2,
                                        times=(0.15 * s, 0.50 * s),
                                        speeds=(25.0, 1.0)),
                 resilience=ResilienceConfig()),
        Scenario(name="crash_loop", traffic="diurnal", n=n,
                 num_replicas=4,
                 events=failure_program(kill_at=0.15 * s, replicas=(3,),
                                        recover_at=0.21 * s)
                 + failure_program(kill_at=0.27 * s, replicas=(3,),
                                   recover_at=0.33 * s)
                 + failure_program(kill_at=0.39 * s, replicas=(3,),
                                   recover_at=0.45 * s)
                 + failure_program(kill_at=0.51 * s, replicas=(3,),
                                   recover_at=0.57 * s),
                 resilience=ResilienceConfig()),
    ]
