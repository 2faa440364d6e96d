"""Trial execution: N seeded runs per (scenario x schedule) cell.

One *trial* is a single deterministic ``simulate_cluster`` run: the
scenario's traffic drawn from the trial seed, its fault/elasticity
events injected mid-stream, and the per-request completion timeline
reduced to a frozen :class:`TrialResult`.  Trials are paired across
schedules — seed ``base_seed + i`` draws the *same* request stream for
every schedule in the comparison, so schedule deltas are measured on
identical workloads (matched-pairs design, the same discipline the
LB4OMP evaluation applies across its techniques).

Determinism is a contract, not an accident: the simulator is seeded
end-to-end, so the same (scenario, schedule, seed) cell reproduces a
byte-identical result — ``TrialResult.digest()`` gives the canonical
hash the property tests (and any cross-machine comparison) check.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Sequence, Union

from ..serve.cluster import TwoLevelSpec, simulate_cluster
from .scenario import Scenario

__all__ = ["TrialResult", "run_trial", "run_cell", "run_suite"]


@dataclasses.dataclass(frozen=True)
class TrialResult:
    """One trial's outcome, frozen and canonically hashable.

    ``served_once`` is the conservation invariant — every submitted rid
    appears in the completion log exactly once, across any kills,
    recoveries and scale events the scenario injected.  ``latencies``
    is the full per-request latency vector (sorted by completion time,
    rid-tiebroken), original-arrival based: a request requeued by a
    fault pays its lost work in its own latency.
    """

    scenario: str
    schedule: str
    seed: int
    n_submitted: int
    n_served: int
    served_once: bool
    makespan: float
    mean_latency: float
    p50: float
    p99: float
    p999: float
    cross_node_pi: float
    migrated: Optional[int]
    latencies: tuple
    # resilience counters (serve/resilience.py), None when the scenario
    # runs the original physics — and then excluded from the digest, so
    # pre-resilience golden digests stay byte-identical
    reclaimed: Optional[int] = None
    duplicates: Optional[int] = None
    quarantines: Optional[int] = None

    @property
    def complete(self) -> bool:
        return self.served_once and self.n_served == self.n_submitted

    def digest(self) -> str:
        """Canonical sha256 of the result (sorted-key JSON, full float
        repr) — equal digests mean byte-identical trials."""
        payload = dataclasses.asdict(self)
        payload["latencies"] = list(payload["latencies"])
        for key in ("reclaimed", "duplicates", "quarantines"):
            if payload[key] is None:
                del payload[key]
        blob = json.dumps(payload, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()


def run_trial(scenario: Scenario, schedule: Union[TwoLevelSpec, str],
              seed: int) -> TrialResult:
    """Run one seeded trial of ``scenario`` under ``schedule``."""
    spec = TwoLevelSpec.parse(schedule)
    requests = scenario.make_requests(seed)
    out = simulate_cluster(
        requests,
        num_replicas=scenario.num_replicas,
        workers_per_replica=scenario.workers_per_replica,
        schedule=spec,
        replica_speed=scenario.replica_speed,
        events=scenario.events,
        return_completions=True,
        resilience=scenario.resilience)
    served = sorted(rid for rid, _ in out["completions"])
    submitted = sorted(r.rid for r in requests)
    res = out.get("resilience")
    return TrialResult(
        scenario=scenario.name,
        schedule=str(spec),
        seed=int(seed),
        n_submitted=len(submitted),
        n_served=len(served),
        served_once=served == submitted,
        makespan=out["makespan"],
        mean_latency=out["mean_latency"],
        p50=out["p50"],
        p99=out["p99"],
        p999=out["p999"],
        cross_node_pi=out["cross_node_pi"],
        migrated=out["migrated_requests"],
        latencies=tuple(out["latencies"]),
        reclaimed=None if res is None else int(res["reclaimed_requests"]),
        duplicates=None if res is None else int(
            res["duplicate_completions"]),
        quarantines=None if res is None else int(res["quarantines"]))


def run_cell(scenario: Scenario, schedule: Union[TwoLevelSpec, str],
             trials: int = 20, base_seed: int = 0) -> list[TrialResult]:
    """Run ``trials`` seeded trials of one (scenario x schedule) cell.

    Seeds are ``base_seed + i``: cells sharing a ``base_seed`` are
    matched pairs (identical request streams per trial index).
    """
    return [run_trial(scenario, schedule, seed=base_seed + i)
            for i in range(trials)]


def run_suite(scenarios: Sequence[Scenario],
              schedules: Sequence[Union[TwoLevelSpec, str]],
              trials: int = 20, base_seed: int = 0,
              ) -> dict[str, dict[str, list[TrialResult]]]:
    """The full grid: ``{scenario.name: {schedule: [TrialResult, ...]}}``."""
    return {
        sc.name: {
            str(TwoLevelSpec.parse(sp)): run_cell(
                sc, sp, trials=trials, base_seed=base_seed)
            for sp in schedules
        }
        for sc in scenarios
    }
