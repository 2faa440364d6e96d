"""The port's torch campaign engine (``repro_torch.core.graph_sim``) on the
CPU against the reference's graph form (``repro.core.graph_sim``, jax x64)
and the port's host batch engine.

Tolerances are the reference's cross-form ones (``tests/test_graph_sim.py``):
bit-exact for p < 8; rtol 1e-9 for p >= 8 (NumPy's pairwise worker-axis
sums; the port keeps the reference's association order, and on the CPU it
is bit-exact there too, but the contract is the tolerance); BOLD carries
the documented log-ulp tolerance (``docs/architecture.md``), rtol 1e-9.
``thread_times`` is held to rtol 1e-12 where the rest is exact, as the
reference holds it.

The cases share a few items instead of being parametrize items of their
own while the reference's order-dependent ``test_shard_as_applies_constraint``
stays unfixed (ROADMAP.md, faults): a test_torch_* file keeps fewer than 12
items.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
from repro.core import graph_sim as ref_gs
import repro_torch.core as port
from repro_torch.core import graph_sim as gs

W, RW = port.sphynx_like(n=2000, seed=1), ref.sphynx_like(n=2000, seed=1)
W2, RW2 = port.nab_like(n=1100, seed=2), ref.nab_like(n=1100, seed=2)
SPEEDS4 = (1.0, 1.3, 0.9, 1.6)
GRAPH_BAND = sorted(n for n in port.REGISTRY
                    if port.REGISTRY[n].graph is not None
                    and isinstance(port.REGISTRY[n].graph.step,
                                   gs.CampaignStep))
EXACT_BAND = sorted(set(GRAPH_BAND) - {"bold"})


def _assert_same(got, want, exact=True, rtol=1e-9):
    assert len(got) == len(want)
    for g, r in zip(got, want):
        rg, rr = g.record, r.record
        assert rg.n_chunks == rr.n_chunks
        if exact:
            assert rg.t_par == rr.t_par
            np.testing.assert_array_equal(rg.thread_finish, rr.thread_finish)
        else:
            np.testing.assert_allclose(rg.t_par, rr.t_par, rtol=rtol)
            np.testing.assert_allclose(rg.thread_finish, rr.thread_finish,
                                       rtol=rtol)
        np.testing.assert_allclose(rg.thread_times, rr.thread_times,
                                   rtol=max(rtol, 1e-12))
        assert (rg.technique, rg.instance, rg.loop, rg.p, rg.chunk_param) == (
            rr.technique, rr.instance, rr.loop, rr.p, rr.chunk_param)


def _both(name, w, rw, **kw):
    """(port graph on the CPU, reference graph, port batch) for one config."""
    prof = kw.pop("profile", "NOISY_PROFILE")
    got = gs.simulate_batch_graph(
        [port.BatchConfig(technique=name, workload=w, **kw)],
        profile=getattr(port, prof), device="cpu")[0]
    want = ref.simulate_batch_graph(
        [ref.BatchConfig(technique=name, workload=rw, **kw)],
        profile=getattr(ref, prof))[0]
    batch = port.simulate_batch(
        [port.BatchConfig(technique=name, workload=w, **kw)],
        profile=getattr(port, prof))[0]
    assert all(g.engine_used == "graph" for g in got)
    return got, want, batch


def test_graph_band_is_the_adaptive_family():
    assert GRAPH_BAND == sorted(
        n for n in port.REGISTRY if port.REGISTRY[n].techdef is not None)
    assert set(GRAPH_BAND) == {"awf", "awf_b", "awf_c", "awf_d", "awf_e",
                               "af", "maf", "bold", "wf2"}
    with pytest.raises(KeyError, match="TechniqueDef"):
        gs.bind_campaign_form("gss")


def test_graph_matches_reference_and_batch_bitexact_small_p():
    """p = 4 < 8 under a loaded scenario (overheads, NUMA, heterogeneous
    speeds, cold cost, multi-timestep state carry, chunk_param
    threshold): bit for bit against both."""
    for name in EXACT_BAND:
        for cp, (w, rw) in ((1, (W, RW)), (7, (W2, RW2))):
            got, want, batch = _both(
                name, w, rw, p=4, chunk_param=cp, timesteps=3,
                speeds=SPEEDS4, numa_penalty=0.4, chunk_cold_cost=1e-7,
                seed=3)
            _assert_same(got, want, exact=True)
            _assert_same(got, batch, exact=True)


def test_graph_large_p_documented_tolerance():
    for name in EXACT_BAND:
        for p in (16, 20):
            got, want, batch = _both(name, W2, RW2, p=p, timesteps=2, seed=5)
            _assert_same(got, want, exact=False)
            _assert_same(got, batch, exact=False)


def test_bold_documented_tolerance():
    for p, speeds in ((4, SPEEDS4), (16, None)):
        got, want, batch = _both("bold", W, RW, p=p, timesteps=2,
                                 speeds=speeds, seed=3)
        _assert_same(got, want, exact=False)
        _assert_same(got, batch, exact=False)


def test_numpy_order_sum_matches_the_reference_order():
    """The vectorised accumulators add in the reference's unrolled order,
    bit for bit, at every width (sequential, 8 accumulators, halving)."""
    rng = np.random.default_rng(0)
    for p in (1, 3, 7, 8, 9, 16, 20, 64, 100, 129, 200, 300):
        x = rng.lognormal(0, 3, (5, p))
        got = gs._numpy_order_sum(torch.from_numpy(x)).numpy()
        with ref_gs.enable_x64():
            want = np.asarray(ref_gs._numpy_order_sum(
                [jnp.asarray(x[:, i]) for i in range(p)]))
        assert want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_engine_used_tags_dedup_and_recorder_stream():
    def stateful(ts, worker, rng):
        return 1.0 + 0.05 * rng.random()

    cfgs = [port.BatchConfig(technique="gss", workload=W2, p=4),
            port.BatchConfig(technique="awf", workload=W2, p=4),
            port.BatchConfig(technique="af", workload=W2, p=4,
                             perturb=stateful),
            port.BatchConfig(technique="awf", workload=W2, p=4, seed=1)]
    rec_g, rec_h = port.LoopRecorder(), port.LoopRecorder()
    graph = gs.simulate_batch_graph(cfgs, recorder=rec_g, device="cpu")
    host = port.simulate_batch(cfgs, recorder=rec_h)
    assert [r[0].engine_used for r in host] == ["plan", "lockstep", "event",
                                                "lockstep"]
    assert [r[0].engine_used for r in graph] == ["plan", "graph", "event",
                                                 "graph"]
    # awf never reads the seed: the last config aliases the second
    assert graph[3][0].record.t_par == graph[1][0].record.t_par
    assert graph[3][0].record is not graph[1][0].record
    assert gs.LAST_RUN["lanes"] == 1 and gs.LAST_RUN["groups"] == 1
    assert [(r.loop, r.technique, r.t_par) for r in rec_g.records] == [
        (r.loop, r.technique, r.t_par) for r in rec_h.records]


def test_strict_knob_and_record_chunks_fall_back_to_host():
    def stateful(ts, worker, rng):
        return 1.0

    bad = [port.BatchConfig(technique="af", workload=W2, p=4,
                            perturb=stateful),
           port.BatchConfig(technique=port.make_technique("awf", 1100, 4),
                            workload=W2, p=4)]
    for cfg in bad:
        assert gs.simulate_batch_graph([cfg], device="cpu")[0][0] \
            .engine_used == "event"
        with pytest.warns(RuntimeWarning, match="falls back"):
            gs.simulate_batch_graph([cfg], strict="warn", device="cpu")
        with pytest.raises(RuntimeError, match="falls back"):
            gs.simulate_batch_graph([cfg], strict=True, device="cpu")
    with pytest.raises(ValueError, match="strict"):
        gs.simulate_batch_graph([], strict="loud", device="cpu")
    cfg = port.BatchConfig(technique="awf_b", workload=W2, p=4)
    res = gs.simulate_batch_graph([cfg], record_chunks=True, device="cpu")
    assert res[0][0].engine_used == "lockstep"
    assert res[0][0].record.chunks is not None


def test_last_run_counts_one_sync_per_round():
    """The engine reads "any lane live" before every round, as the
    reference's while_loop condition does: per timestep one read per round
    plus the read that ends it, and one read per group for the results.
    Mixed lane lengths (n, chunk_param, timesteps) keep lanes finishing
    apart, and the results equal the batch engine's bit for bit (p < 8)."""
    cfgs = [port.BatchConfig(technique="af", workload=w, p=6, chunk_param=cp,
                             timesteps=ts, seed=1)
            for w, cp, ts in ((W, 1, 2), (W2, 5, 1), (W2, 1, 3))]
    got = gs.simulate_batch_graph(cfgs, device="cpu")
    stats = dict(gs.LAST_RUN)
    assert stats["device"] == "cpu"
    assert stats["lanes"] == 3 and stats["groups"] == 1
    assert stats["rounds"] >= 1
    assert stats["syncs"] == stats["rounds"] + 3 + 1
    for a, b in zip(got, port.simulate_batch(cfgs)):
        _assert_same(a, b, exact=True)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port.BatchConfig(technique="awf", workload=W2, p=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gs.simulate_batch_graph([cfg])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.auto_simulate(W2, p=4, timesteps=2, engine="graph")
