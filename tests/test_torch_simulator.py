"""Parity of the port's simulators (``repro_torch.core.workloads``,
``simulator`` and ``batch_sim``, NumPy copies) with the JAX package's on
the CPU: workload arrays are equal; ``simulate`` gives identical
SimResults for all 27 techniques; ``simulate_batch == simulate`` and both
equal the reference's.  Everything is float64 NumPy on both sides, so
every comparison is exact.

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

import contextlib
import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port

TECHNIQUES = tuple(port.REGISTRY)
SPEEDS = (1.0, 1.4, 0.9, 1.2, 2.0)


def _same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        rx, ry = x.record, y.record
        assert (rx.loop, rx.technique, rx.instance, rx.p, rx.n,
                rx.chunk_param, rx.n_chunks) == (
            ry.loop, ry.technique, ry.instance, ry.p, ry.n, ry.chunk_param,
            ry.n_chunks)
        assert rx.t_par == ry.t_par and rx.sched_time == ry.sched_time
        np.testing.assert_array_equal(rx.thread_times, ry.thread_times)
        np.testing.assert_array_equal(rx.thread_finish, ry.thread_finish)
        assert (rx.chunks is None) == (ry.chunks is None)
        if rx.chunks is not None:
            assert [(type(c).__name__, dataclasses.asdict(c))
                    for c in rx.chunks] == [
                (type(c).__name__, dataclasses.asdict(c)) for c in ry.chunks]


def _workloads(mod):
    return [mod.make_workload(f"dist-{l}", n=500, seed=3)
            for l in mod.DIST_LOOPS] + [
        mod.make_workload(f"stream-{k}", n=2000, seed=1)
        for k in mod.STREAM_LOOPS] + [
        mod.sphynx_like(n=3000, seed=2), mod.frontloaded_like(n=2500, seed=4),
        mod.gromacs_like(n=4000, seed=5), mod.nab_like(seed=6)]


def test_workload_arrays_equal():
    for a, b in zip(_workloads(port), _workloads(ref), strict=True):
        assert a.name == b.name and a.meta == b.meta
        assert a.costs.dtype == b.costs.dtype == np.float64
        np.testing.assert_array_equal(a.costs, b.costs)
        assert (a.n, a.mu, a.sigma, a.total) == (b.n, b.mu, b.sigma, b.total)
    assert port.nab_like().n == 44_794
    with pytest.raises(KeyError, match="unknown workload"):
        port.make_workload("nope")
    for prof in ("EXACT_PROFILE", "NOISY_PROFILE"):
        w, rw = port.sphynx_like(n=2000, seed=9), ref.sphynx_like(n=2000, seed=9)
        assert port.profile_workload(w, getattr(port, prof)) == \
            ref.profile_workload(rw, getattr(ref, prof))


def test_simulate_identical_for_every_technique():
    """A loaded scenario: heterogeneous speeds, NUMA penalty, cold cost,
    noisy profiling, chunk_param threshold, timestep state carry, chunk
    logs."""
    w, rw = port.sphynx_like(n=1500, seed=1), ref.sphynx_like(n=1500, seed=1)
    for name in TECHNIQUES:
        for cp in (1, 9):
            kw = dict(timesteps=2, speeds=SPEEDS, numa_penalty=0.3,
                      chunk_cold_cost=1e-7, seed=3, record_chunks=True)
            got = port.simulate(name, w, 5, cp, profile=port.NOISY_PROFILE,
                                **kw)
            want = ref.simulate(name, rw, 5, cp, profile=ref.NOISY_PROFILE,
                                **kw)
            _same_records(got, want)
            assert all(r.engine_used == "event" for r in got)


def test_simulate_mutex_perturb_weights_and_recorder():
    """The FAC mutex path, a stateful and a pure perturb, wf2 weights and
    the recorder's summary."""
    w, rw = port.nab_like(n=3000, seed=2), ref.nab_like(n=3000, seed=2)
    rec_p, rec_r = port.LoopRecorder(), ref.LoopRecorder()
    for name, extra in (("fac", {}), ("mfac", {}),
                        ("wf2", dict(weights=[1.0, 2.0, 1.0, 0.5])),
                        ("awf_c", dict(perturb=lambda ts, wk: 1.0 + 0.1 * wk)),
                        ("af", dict(perturb=lambda ts, wk, rng:
                                    1.0 + 0.05 * rng.random())),
                        ("rand", {})):
        got = port.simulate(name, w, 4, timesteps=3, recorder=rec_p, seed=7,
                            **extra)
        want = ref.simulate(name, rw, 4, timesteps=3, recorder=rec_r, seed=7,
                            **extra)
        _same_records(got, want)
    assert rec_p.summary() == rec_r.summary()


def test_simulate_batch_equals_simulate_and_reference():
    w, rw = port.sphynx_like(n=1200, seed=4), ref.sphynx_like(n=1200, seed=4)
    common = dict(timesteps=2, speeds=SPEEDS[:4], numa_penalty=0.2,
                  chunk_cold_cost=5e-8)
    grid_p = port.batch_grid(TECHNIQUES, [w], ps=(4,), chunk_params=(1, 6),
                             seeds=(0, 1), **common)
    grid_r = ref.batch_grid(TECHNIQUES, [rw], ps=(4,), chunk_params=(1, 6),
                            seeds=(0, 1), **common)
    got = port.simulate_batch(grid_p, profile=port.NOISY_PROFILE)
    want = ref.simulate_batch(grid_r, profile=ref.NOISY_PROFILE)
    for cfg, g, r in zip(grid_p, got, want, strict=True):
        _same_records(g, r)
        assert [x.engine_used for x in g] == [x.engine_used for x in r]
        oracle = port.simulate(cfg.technique, w, 4, cfg.chunk_param,
                               seed=cfg.seed, profile=port.NOISY_PROFILE,
                               **common)
        _same_records(g, oracle)


def test_simulate_batch_fallbacks_and_chunks_match_reference():
    w, rw = port.gromacs_like(n=2000, seed=1), ref.gromacs_like(n=2000, seed=1)

    def stateful(ts, wk, rng):
        return 1.0 + 0.02 * rng.random()

    for strict in (False, "warn"):
        cfgs_p = [port.BatchConfig(technique=t, workload=w, p=6, seed=2,
                                   perturb=stateful if t == "awf" else None)
                  for t in ("static", "fac", "awf", "ws_rr", "dls_steal")]
        cfgs_r = [ref.BatchConfig(technique=t, workload=rw, p=6, seed=2,
                                  perturb=stateful if t == "awf" else None)
                  for t in ("static", "fac", "awf", "ws_rr", "dls_steal")]
        with (pytest.warns(RuntimeWarning) if strict
              else contextlib.nullcontext()):
            got = port.simulate_batch(cfgs_p, strict=strict,
                                      record_chunks=True)
        want = ref.simulate_batch(cfgs_r, record_chunks=True)
        for g, r in zip(got, want, strict=True):
            _same_records(g, r)
            assert [x.engine_used for x in g] == [x.engine_used for x in r]


def test_best_combination_matches_reference():
    rows = [dict(loop="L0", technique=t, mean_t_par=v)
            for t, v in (("gss", 2.0), ("fac2", 1.5), ("static", 1.7))]
    rows += [dict(loop="L1", technique="ss", mean_t_par=3.0)]
    assert port.best_combination(rows) == ref.best_combination(rows)
