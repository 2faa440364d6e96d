"""The port's ``serve/resilience.py`` against the reference's, on the CPU.

The 20 golden trial digests (``tests/data/pr8_trial_digests.json``,
the resilience-disabled path) must come out of the port byte for byte.
``simulate_cluster_resilient`` on the thermal and kill scenarios, and the
``HealthTracker`` state machine, must give the reference's results
exactly: the ``ReclaimGrant`` list, the counters, the completions."""

import json
from pathlib import Path

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import pytest

import repro.serve.cluster as ref_cluster
import repro.serve.resilience as ref_resilience
import repro.trials as ref_trials
import repro_torch.serve.cluster as port_cluster
import repro_torch.serve.resilience as port_resilience
import repro_torch.trials as port_trials

DATA = Path(__file__).resolve().parent / "data"
PACKAGES = {"ref": (ref_cluster, ref_resilience, ref_trials),
            "port": (port_cluster, port_resilience, port_trials)}


def _both(fn):
    """``fn(cluster, resilience, trials)`` on both packages; assert the two
    results equal as JSON text and return the port's."""
    got = {name: fn(*mods) for name, mods in PACKAGES.items()}
    assert (json.dumps(got["port"], sort_keys=True)
            == json.dumps(got["ref"], sort_keys=True))
    return got["port"]


def _golden_scenarios(trials):
    """The fault / elasticity sweep the golden digests pin
    (tests/test_resilience.py)."""
    S = trials.Scenario
    return [
        S(name="kill_recover", traffic="spiky", n=120, num_replicas=3,
          events=trials.failure_program(kill_at=0.05, replicas=(0,),
                                        recover_at=0.2)),
        S(name="kill_forever", traffic="zipf", n=120, num_replicas=3,
          events=trials.failure_program(kill_at=0.05, replicas=(0, 1))),
        S(name="scale_up", traffic="bursty", n=120, num_replicas=2,
          events=trials.elastic_program((0.05, 5))),
        S(name="scale_down", traffic="spiky", n=120, num_replicas=4,
          events=trials.elastic_program((0.05, 2))),
        S(name="thermal", traffic="diurnal", n=120, num_replicas=3,
          events=trials.thermal_program(0, times=(0.05, 0.1),
                                        speeds=(2.0, 5.0))),
    ]


def test_port_reproduces_the_golden_digests():
    gold = json.loads((DATA / "pr8_trial_digests.json").read_text())
    assert len(gold["digests"]) == 20
    got = {f"{sc.name}|{sp}": port_trials.run_trial(
               sc, sp, seed=gold["seed"]).digest()
           for sc in _golden_scenarios(port_trials) for sp in gold["schedules"]}
    assert got == gold["digests"]


def test_resilient_runs_match_reference():
    """``ResilienceConfig()`` on the thermal and kill scenarios, and a
    straggler that the breaker quarantines, probes and readmits."""
    def run(cluster, resilience, trials):
        cfg = resilience.ResilienceConfig()
        programs = {
            "thermal": trials.thermal_program(0, times=(0.05, 0.1),
                                              speeds=(2.0, 5.0)),
            "kill": trials.failure_program(kill_at=0.05, replicas=(0,),
                                           recover_at=0.2),
            "straggler": trials.thermal_program(1, times=(0.05, 0.25),
                                                speeds=(12.0, 1.0)),
            "kill_scale": (cluster.ReplicaKill(time=0.04, replica=2),
                           cluster.ScaleTo(time=0.1, num_replicas=4)),
        }
        out = []
        for name, evs in programs.items():
            for schedule in ("static/fac2", "awf_b/fac2", "fac2/fac2"):
                res = resilience.simulate_cluster_resilient(
                    cluster.make_traffic("diurnal", n=200, seed=3),
                    num_replicas=3, schedule=schedule, events=evs,
                    return_completions=True, resilience=cfg)
                out.append((name, schedule, res))
        tight = resilience.ResilienceConfig(max_hedges=1, deadline_k=1.5)
        out.append(cluster.simulate_cluster(
            cluster.make_traffic("spiky", n=300, seed=0), num_replicas=4,
            schedule="awf_b/fac2", events=programs["straggler"],
            return_completions=True, resilience=tight))
        return out

    got = _both(run)
    stats = [g[2]["resilience"] for g in got[:-1]]
    assert any(s["reclaims"] for s in stats)
    assert any(s["quarantines"] for s in stats)


def test_health_tracker_transitions_match_reference():
    def run(_, resilience, __):
        cfg = resilience.ResilienceConfig(ewma_alpha=0.5, suspect_ratio=2.5,
                                          quarantine_ratio=5.0,
                                          quarantine_misses=2)
        h = resilience.HealthTracker(3, cfg, base_speed=[1.0, 2.0, 4.0])
        seq = []
        script = [("observe", 0, 1.0), ("observe", 0, 3.0),
                  ("observe", 0, 10.1), ("on_miss", 1), ("on_miss", 1),
                  ("observe", 2, 4.0), ("relax", 2), ("on_kill", 2),
                  ("reset", 0, 2.0), ("observe", 1, 2.0), ("relax", 1),
                  ("on_miss", 2), ("reset", 2, None)]
        for op, rep, *arg in script:
            ret = getattr(h, op)(rep, *arg)
            seq.append((op, rep, ret, list(h.state), list(h.misses),
                        list(h.crashes),
                        [float(x) for x in h.slowness],
                        [float(x) for x in h.deadline_scale],
                        h.allowed_span(rep, span=1.0, wait=0.3),
                        h.healthy_slowness([0, 1, 2])))
        with pytest.raises(ValueError):
            resilience.ResilienceConfig(suspect_ratio=6.0,
                                        quarantine_ratio=5.0)
        return seq

    seq = _both(run)
    # the tracker is advisory: quarantine shows in what it returns
    verdicts = {step[2] for step in seq}
    assert {"healthy", "suspect", "quarantined"} <= verdicts
