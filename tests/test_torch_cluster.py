"""The port's ``serve/cluster.py`` against the reference's, on the CPU.

The same seeded traffic goes through both packages' ``make_traffic``,
``ClusterRouter``, ``simulate_cluster`` and ``simulate_cluster_batch``.
Every output is held equal byte for byte (the result dicts through
``json.dumps``): request streams, router pull sequences and telemetry,
makespans, latencies, ``cross_node_pi``, migrated requests, node weights
and the ``ClusterRecord`` projections a recorder collects."""

import json

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import pytest

import repro.core.metrics as ref_metrics
import repro.serve.cluster as ref_cluster
import repro_torch.core.metrics as port_metrics
import repro_torch.serve.cluster as port_cluster

PACKAGES = {"ref": (ref_cluster, ref_metrics),
            "port": (port_cluster, port_metrics)}
KINDS = ("uniform", "heavy_tail", "spiky", "zipf", "bursty", "diurnal",
         "flash_crowd")


def _both(fn):
    """``fn(cluster, metrics)`` on both packages; assert the two results
    equal as JSON text and return the port's."""
    got = {name: fn(*mods) for name, mods in PACKAGES.items()}
    assert (json.dumps(got["port"], sort_keys=True)
            == json.dumps(got["ref"], sort_keys=True))
    return got["port"]


def _stream(reqs):
    return [(r.rid, r.arrival, r.prompt_len, r.max_new_tokens, r.cost)
            for r in reqs]


def _records(recorder):
    return [(r.loop, r.technique, r.instance, r.p, r.n, r.chunk_param,
             r.t_par, r.thread_times.tolist(), r.thread_finish.tolist(),
             r.n_chunks, r.sched_time) for r in recorder.records]


def test_make_traffic_matches_reference():
    def run(cluster, _):
        out = [_stream(cluster.make_traffic(k, n=n, seed=s))
               for k in KINDS for n, s in ((300, 0), (97, 3))]
        with pytest.raises(ValueError, match="unknown traffic kind"):
            cluster.make_traffic("poisson")
        return out

    _both(run)


def test_router_sequences_match_reference():
    """Pull / complete / ``set_active`` / ``take_one`` / ``neutralize``
    scripts on self-scheduling and steal-band routers."""
    def run(cluster, _):
        out = []
        for schedule in ("awf_b", "awf_c", "af", "fac2", "gss", "static",
                         "ws_rr,4", "ws_rp,2"):
            router = cluster.ClusterRouter(3, schedule=schedule)
            steal = router._steal
            for r in cluster.make_traffic("spiky", n=90, seed=1):
                router.submit(r)
            seq = []
            for step in range(40):
                # replica 2 pulls least: the steal band migrates its share
                rep = (0, 1, 0, 1, 2, 3)[step % 6] % router.num_replicas
                if not steal and step == 9:
                    router.set_active([0, 2])          # replica 1 dies
                if not steal and step == 15:
                    seq.append(("take", getattr(router.take_one(), "rid",
                                                None)))
                if not steal and step == 18:
                    router.set_active([0, 1, 2, 3])    # recover + grow
                    router.neutralize(1)
                chunk = router.pull(rep)
                seq.append((rep, [r.rid for r in chunk], router.backlog))
                router.complete(rep, busy=sum(r.cost for r in chunk)
                                * (1.0 + 2.0 * (rep == 2)))
            w = router.node_weights
            out.append((schedule, steal, seq, router.replica_busy.tolist(),
                        router.replica_requests.tolist(), router.node_chunks,
                        None if w is None else w.tolist(),
                        getattr(router, "migrated_requests", None)))
        return out

    got = _both(run)
    assert any(m for *_, m in got)  # the steal band did migrate


def test_simulate_cluster_matches_reference():
    """``simulate_cluster`` records on uniform / heavy_tail / zipf traffic
    under static, awf_b and a steal-band node schedule, with even and
    heterogeneous replicas, through a recorder and a reused router."""
    def run(cluster, metrics):
        out = []
        for kind in ("uniform", "heavy_tail", "zipf"):
            reqs = cluster.make_traffic(kind, n=240, seed=2)
            for schedule in ("static/fac2", "awf_b/fac2", "ws_rr,4/fac2",
                             "fac2/gss,2"):
                for speed in (None, [1.0, 1.0, 3.0, 0.5]):
                    rec = metrics.LoopRecorder()
                    res = cluster.simulate_cluster(
                        reqs, num_replicas=4, workers_per_replica=3,
                        schedule=schedule, replica_speed=speed,
                        recorder=rec, return_completions=True)
                    out.append((kind, schedule, speed, res, _records(rec)))
        # wave-by-wave serving with one router
        router = cluster.ClusterRouter(3, schedule="awf_b")
        for seed in (0, 1):
            out.append(cluster.simulate_cluster(
                cluster.make_traffic("spiky", n=120, seed=seed),
                num_replicas=3, schedule="awf_b/fac2", router=router))
        return out

    got = _both(run)
    assert {g[3]["migrated_requests"] is not None for g in got[:-2]} == {
        True, False}


def test_every_event_type_matches_reference():
    def run(cluster, _):
        E = cluster
        programs = [
            [E.ReplicaKill(time=0.04, replica=0)],
            [E.ReplicaKill(time=0.03, replica=1),
             E.ReplicaRecover(time=0.2, replica=1, speed=2.0)],
            [E.ReplicaSpeed(time=0.05, replica=2, speed=6.0)],
            [E.ScaleTo(time=0.02, num_replicas=5)],
            [E.ScaleTo(time=0.05, num_replicas=2),
             E.ScaleTo(time=0.3, num_replicas=4)],
            [E.ReplicaKill(time=0.05, replica=0),
             E.ScaleTo(time=0.1, num_replicas=1),
             E.ReplicaRecover(time=0.15, replica=0),
             E.ReplicaSpeed(time=0.15, replica=0, speed=0.5)],
        ]
        out = []
        for evs in programs:
            for schedule in ("static/fac2", "awf_b/fac2", "af/fac2"):
                out.append(cluster.simulate_cluster(
                    cluster.make_traffic("spiky", n=150, seed=5),
                    num_replicas=3, schedule=schedule, events=evs,
                    return_completions=True))
        errors = []
        for evs in ([E.ReplicaRecover(time=0.1, replica=0)],
                    [E.ReplicaKill(time=0.1, replica=0),
                     E.ReplicaKill(time=0.2, replica=0)]):
            with pytest.raises(ValueError) as err:
                cluster.simulate_cluster(
                    cluster.make_traffic("uniform", n=10),
                    num_replicas=2, events=evs)
            errors.append(str(err.value))
        with pytest.raises(ValueError, match="steal-band"):
            cluster.simulate_cluster(
                cluster.make_traffic("uniform", n=10), num_replicas=2,
                schedule="ws_rr,4/fac2", events=programs[0])
        return out, errors

    _both(run)


def test_simulate_cluster_batch_matches_reference():
    def run(cluster, metrics):
        traffics = {k: cluster.make_traffic(k, n=160, seed=4)
                    for k in ("uniform", "zipf", "bursty")}
        grid = cluster.cluster_grid(
            ["static/fac2", "awf_b/fac2", "gss/fac2", "static/fac2"],
            traffics, num_replicas=4, workers_per_replica=2)
        rec = metrics.LoopRecorder()
        res = cluster.simulate_cluster_batch(grid, recorder=rec)
        # the duplicated static/fac2 point is simulated once per traffic
        return ([(c.traffic, str(c.schedule)) for c in grid], res,
                _records(rec))

    grid, res, recs = _both(run)
    assert len(res) == len(grid) == 12 and len(recs) == 9
