"""Parity of the port's closed forms (``repro_torch.core.torch_sched``)
with the JAX reference (``repro.core.jax_sched``) and with the host
techniques, on the CPU: ``plan_chunks`` for every plannable technique,
``max_chunks_bound``, the under-sized ``max_chunks`` contract,
``awf_update``, the AF state and chunk rule, ``balanced_assignment`` and
``plan_schedule(backend="graph")``.

Integer outputs (sizes, starts, counts, assignments, plans) must be
identical.  The reference computes ``awf_update`` and the AF forms in
float32 (jax without x64); the port keeps the inputs' dtype, so those
are held to 1e-6 relative in float32 (a float32 operation sequence of the
same order, summed over 4-6 workers).  The port's ``plan_chunks`` runs
its float forms in float64 (the host techniques' precision) where the
reference runs float32: both must equal the host plan on the grid of
``tests/test_jax_sched.py``.

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
import repro.core.jax_sched as jsched
import repro_torch.core as port
from repro_torch.core import torch_sched as tsched

PLANNABLE = ("static", "ss", "gss", "tss", "fac2", "fac", "mfac", "tap", "fsc")
GRAPH_FORMS = PLANNABLE + ("wf2",)
GRID = ((1000, 4, 1), (10_007, 16, 1), (5000, 7, 13), (64, 64, 1))
PROFILED = dict(mu=1.0, sigma=0.4, h=1e-6)


def _kw(name):
    return PROFILED if port.REGISTRY[name].meta.requires_profiling else {}


def _host_sizes(name, n, p, cp, **kw):
    return [c.size for c in port.plan_schedule(name, n=n, p=p, chunk_param=cp,
                                               **kw).chunks]


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def test_plan_chunks_matches_reference_and_host_plans():
    for name in PLANNABLE:
        for n, p, cp in GRID:
            kw = _kw(name)
            sizes, starts, count = tsched.plan_chunks(name, n, p, cp,
                                                      device="cpu", **kw)
            assert sizes.dtype == starts.dtype == count.dtype == torch.int32
            count = int(count)
            got = sizes[:count].tolist()
            assert got == _host_sizes(name, n, p, cp, **kw), (name, n, p, cp)
            np.testing.assert_array_equal(
                starts[:count].numpy(), np.concatenate([[0], np.cumsum(got)[:-1]]))
            rs, rst, rc = jsched.plan_chunks(name, n, p, cp, **kw)
            assert int(rc) == count, (name, n, p, cp)
            np.testing.assert_array_equal(sizes.numpy(), _np(rs))
            np.testing.assert_array_equal(starts.numpy(), _np(rst))


def test_plan_chunks_wf2_weighted_round_robin():
    n, p = 10_000, 4
    w = np.array([2.0, 1.0, 1.0, 0.5])
    sizes, _, count = tsched.plan_chunks("wf2", n, p, 1, weights=w,
                                         device="cpu")
    got = sizes[:int(count)].tolist()
    assert got == _host_sizes("wf2", n, p, 1, weights=list(w))
    rs, _, rc = jsched.plan_chunks("wf2", n, p, 1, weights=jnp.asarray(w))
    assert got == list(_np(rs)[:int(rc)])


def test_max_chunks_bound_matches_reference_and_is_sufficient():
    for name in port.REGISTRY:
        for n, p, cp in ((100, 3, 1), (99_991, 32, 1), (1000, 6, 9)):
            bound = tsched.max_chunks_bound(name, n, p, cp)
            assert bound == jsched.max_chunks_bound(name, n, p, cp), name
            if name in GRAPH_FORMS or port.REGISTRY[name].techdef is not None:
                assert len(_host_sizes(name, n, p, cp, **_kw(name))) <= bound
    spec = port.ScheduleSpec("fac2", 7)
    assert tsched.max_chunks_bound(spec, 500, 4) == jsched.max_chunks_bound(
        ref.ScheduleSpec("fac2", 7), 500, 4)


def test_plan_chunks_undersized_max_chunks_matches_reference():
    """max_chunks is a padding bound, never a truncation: the remainder
    folds into the last slot, exactly as in the reference."""
    for name in GRAPH_FORMS:
        for n, p, cp in ((1000, 4, 7), (1000, 4, 1), (97, 3, 10)):
            kw = _kw(name)
            natural = len(_host_sizes(name, n, p, cp, **kw))
            for mc in (1, 2, max(1, natural // 2), natural):
                sizes, starts, count = tsched.plan_chunks(
                    name, n, p, cp, max_chunks=mc, device="cpu", **kw)
                assert int(count) <= mc and int(sizes.sum()) == n
                rs, rst, rc = jsched.plan_chunks(name, n, p, cp,
                                                 max_chunks=mc, **kw)
                assert int(count) == int(rc), (name, mc)
                np.testing.assert_array_equal(sizes.numpy(), _np(rs))
                np.testing.assert_array_equal(starts.numpy(), _np(rst))


def test_plan_chunks_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="max_chunks"):
        tsched.plan_chunks("ss", 100, 4, 1, max_chunks=0, device="cpu")
    with pytest.raises(KeyError, match="campaign"):
        tsched.plan_chunks("awf", 100, 4, device="cpu")
    with pytest.raises(KeyError, match="unsupported"):
        tsched.plan_chunks("ws_rr", 100, 4, device="cpu")
    assert sorted(port.REGISTRY.graph_names(plannable=True)) == sorted(
        ref.REGISTRY.graph_names(plannable=True)) == sorted(GRAPH_FORMS)
    assert sorted(port.REGISTRY.graph_names()) == sorted(
        ref.REGISTRY.graph_names())


def test_awf_update_matches_reference_and_host():
    p = 6
    host = port.make_technique("awf_b", n=100_000, p=p)
    wn, wd, k = (torch.zeros(p), torch.zeros(p),
                 torch.tensor(0, dtype=torch.int32))
    rn, rd, rk = jnp.zeros(p), jnp.zeros(p), jnp.asarray(0, jnp.int32)
    rng = np.random.default_rng(0)
    for _ in range(3):
        times = rng.uniform(0.5, 2.0, p).astype(np.float32)
        sizes = rng.integers(10, 100, p).astype(np.float32)
        sizes[2] = 0.0 if _ == 1 else sizes[2]      # a worker without data
        host._sum_time[:] = times
        host._sum_size[:] = sizes
        host._adapt()
        w, wn, wd, k = tsched.awf_update(wn, wd, k, torch.from_numpy(times),
                                         torch.from_numpy(sizes))
        rw, rn, rd, rk = jsched.awf_update(rn, rd, rk, jnp.asarray(times),
                                           jnp.asarray(sizes))
        for a, b in ((w, rw), (wn, rn), (wd, rd)):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6)
        assert int(k) == int(rk)
    np.testing.assert_allclose(w.numpy(), host.weights, rtol=1e-5)
    assert abs(float(w.sum()) - p) < 1e-5 * p


def test_af_state_and_chunk_match_reference():
    p = 4
    host = port.make_technique("af", n=1_000_000, p=p)
    s = tsched.af_init(p, device="cpu")
    rs = jsched.af_init(p)
    rng = np.random.default_rng(1)
    for _ in range(3):
        per_iter = rng.uniform(0.5, 2.0, p)
        times, sizes = np.zeros(p), np.zeros(p)
        for i in range(p):
            g = host.next_chunk(i)
            sizes[i] = g.size
            times[i] = per_iter[i] * g.size
            host.complete_chunk(i, g, exec_time=float(times[i]))
        s = tsched.af_update(s, torch.tensor(times, dtype=torch.float32),
                             torch.tensor(sizes, dtype=torch.float32))
        rs = jsched.af_update(rs, jnp.asarray(times, jnp.float32),
                              jnp.asarray(sizes, jnp.float32))
        for a, b in zip(s, rs):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6)
    np.testing.assert_allclose(s.mean.numpy(), host._mean, rtol=1e-4)
    np.testing.assert_allclose(s.cnt.numpy(), host._cnt, rtol=1e-6)
    for rem in (float(host.remaining), 1e3, 17.0):
        c = tsched.af_chunk(s, rem)
        assert c.dtype == torch.int32
        np.testing.assert_array_equal(c.numpy(), _np(jsched.af_chunk(
            rs, jnp.asarray(rem))))
    assert int(c.min()) >= 1


def test_balanced_assignment_matches_reference():
    rng = np.random.default_rng(0)
    costs = rng.lognormal(0, 1, 512).astype(np.float32)
    costs[::7] = costs[3]                            # ties keep their order
    for weights, p in ((None, 8), (np.array([3.0, 1.0], np.float32), 2),
                       (np.array([1.0, 0.5, 2.0], np.float32), 3)):
        got = tsched.balanced_assignment(torch.from_numpy(costs), p=p,
                                         weights=weights)
        want = jsched.balanced_assignment(
            jnp.asarray(costs), p=p,
            weights=None if weights is None else jnp.asarray(weights))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _np(want))
    loads = np.bincount(got.numpy(), weights=costs, minlength=3)
    assert loads.max() <= 1.4 * loads.mean() * 2.0  # weighted shares


def test_plan_schedule_graph_backend_matches_host_and_reference(monkeypatch):
    """backend="graph" materializes the closed form: the same chunks as
    the host plan and as the reference's graph plan, on the CPU when
    asked; by default it asks for the card and raises without one."""
    for name in GRAPH_FORMS:
        for n, p, cp in ((1000, 8, 1), (257, 3, 5)):
            kw = _kw(name)
            got = port.plan_schedule(f"{name},{cp},backend=graph", n, p,
                                     device="cpu", **kw)
            host = port.plan_schedule(name, n, p, chunk_param=cp, **kw)
            want = ref.plan_schedule(f"{name},{cp},backend=graph", n, p, **kw)
            chunks = [(c.worker, c.start, c.size, c.batch) for c in got.chunks]
            assert chunks == [(c.worker, c.start, c.size, c.batch)
                              for c in want.chunks], name
            assert [c.size for c in got.chunks] == [c.size for c in host.chunks]
            assert got.chunk_param == want.chunk_param
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.plan_schedule("gss,1,backend=graph", 100, 4)
