"""The port's ``trials`` package against the reference's, on the CPU.

``run_cell`` / ``run_suite`` over ``standard_suite(quick=True)`` must give
the reference's ``TrialResult`` digests (sha256 of the result's JSON, so
any change in the order of float operations shows); a trace written by one
package must read back identically in the other; the statistics layer
(seeded bootstrap CIs, percentiles, cell summaries and comparisons, the
tolerance-band gates) must return the reference's values exactly."""

import json

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest

import repro.trials as ref_trials
import repro_torch.trials as port_trials

PACKAGES = {"ref": ref_trials, "port": port_trials}
SCHEDULES = ("static/fac2", "fac2/fac2", "awf_b/fac2", "gss/fac2")


def _both(fn):
    """``fn(trials)`` on both packages; assert the two results equal as
    JSON text and return the port's."""
    got = {name: fn(mod) for name, mod in PACKAGES.items()}
    assert (json.dumps(got["port"], sort_keys=True)
            == json.dumps(got["ref"], sort_keys=True))
    return got["port"]


def test_standard_suite_digests_match_reference():
    def run(trials):
        suite = trials.standard_suite(quick=True)
        out = trials.run_suite(suite, SCHEDULES, trials=2, base_seed=5)
        return {sc: {sp: [r.digest() for r in cell]
                     for sp, cell in cells.items()}
                for sc, cells in out.items()}

    got = _both(run)
    assert len(got) == 8 and all(len(c) == 4 for c in got.values())


def test_run_cell_results_match_reference():
    def run(trials):
        sc = trials.Scenario(name="mini", traffic="flash_crowd", n=150,
                             num_replicas=3,
                             events=trials.failure_program(
                                 kill_at=0.1, replicas=(1,), recover_at=0.3))
        out = []
        for sp in SCHEDULES + ("ws_rr,4/fac2",):
            ev = () if sp.startswith("ws_") else sc.events
            cell = trials.run_cell(
                trials.Scenario(name=sc.name, traffic=sc.traffic, n=sc.n,
                                num_replicas=sc.num_replicas, events=ev),
                sp, trials=3, base_seed=7)
            out.append([(r.digest(), r.complete, r.seed, r.n_submitted)
                        for r in cell])
        return out

    _both(run)


def test_trace_round_trip_across_packages(tmp_path):
    reqs = {name: mod.Scenario(name="t", traffic="bursty", n=80,
                               num_replicas=2).make_requests(11)
            for name, mod in PACKAGES.items()}
    for writer, reader in (("ref", "port"), ("port", "ref")):
        path = tmp_path / f"{writer}.json"
        PACKAGES[writer].save_trace(str(path), reqs[writer])
        trace = PACKAGES[reader].load_trace(str(path))
        back = PACKAGES[reader].requests_from_trace(trace)
        assert trace == PACKAGES[writer].trace_from_requests(reqs[writer])
        assert [(r.rid, r.arrival, r.prompt_len, r.max_new_tokens)
                for r in back] == [(r.rid, r.arrival, r.prompt_len,
                                    r.max_new_tokens) for r in reqs[writer]]
    assert ((tmp_path / "ref.json").read_bytes()
            == (tmp_path / "port.json").read_bytes())

    def replay(trials):
        sc = trials.Scenario(name="replay", trace=trials.load_trace(
            str(tmp_path / "ref.json")), num_replicas=2,
            events=trials.failure_program(kill_at=0.05, replicas=(0,),
                                          recover_at=0.2))
        return [trials.run_trial(sc, sp, seed=s).digest()
                for sp in SCHEDULES for s in (0, 1)]

    _both(replay)


def test_statistics_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(10.0, 1.0, size=40).tolist()
    lat = rng.lognormal(0.0, 1.0, size=997).tolist()

    def run(trials):
        p99 = lambda s: float(np.percentile(s, 99))  # noqa: E731
        cis = [trials.bootstrap_ci(x, seed=s) for s in (1, 2)]
        cis += [trials.bootstrap_ci(x, stat=p99, n_boot=300, seed=0),
                trials.bootstrap_ci(x, alpha=0.1, seed=3),
                trials.bootstrap_ci([]), trials.bootstrap_ci([4.2]),
                trials.bootstrap_ci([3.0, 3.0, 3.0])]
        pct = [trials.latency_percentiles(lat),
               trials.latency_percentiles([])]
        sc = trials.Scenario(name="mini", traffic="flash_crowd", n=120,
                             num_replicas=3)
        fast = trials.run_cell(sc, "awf_b/fac2", trials=4)
        slow = trials.run_cell(sc, "static/fac2", trials=4)
        summ = trials.summarize_cell(fast)
        cmp_ = [trials.compare_cells(fast, slow, metric=m)
                for m in ("p99", "makespan", "mean_latency")]
        overlap = [trials.ci_nonoverlap(a, b) for a, b in
                   (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 5), (1, 2)))]
        band = trials.ToleranceBand(0.8, 3.0)
        gates = trials.check_gates([
            ("in", 1.5, trials.ToleranceBand(1.0, 2.0)),
            ("out", 9.0, trials.ToleranceBand(0.0, 1.0)),
            ("nan", float("nan"), band)])
        with pytest.raises(ValueError):
            trials.ToleranceBand(2.0, 1.0)
        return (cis, pct, summ, cmp_, overlap, tuple(band),
                band.contains(1.0), band.check("b", 3.5), gates)

    got = _both(run)
    assert got[0][0] != got[0][1]  # the seed matters
