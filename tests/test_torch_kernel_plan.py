"""Parity of the port's kernel-tile planner with the JAX reference:
``KernelTilePlan`` (order, step_worker, worker_cost, n_chunks, sched_time,
to_record) from ``repro_torch.core.torch_sched`` against
``repro.core.jax_sched`` for every spec x assign, with and without weights
and per-chunk overhead; the plan cache; the MoE tile planner and balancer;
the flash-attention descriptor planner; and the per-CTA bounds the CUDA
kernels take.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest

import repro.core.jax_sched as jsched
from repro.balance import moe as ref_moe
from repro.kernels.flash_attention import flash_attention as ref_fa
from repro_torch.balance import moe as port_moe
from repro_torch.core import REGISTRY
from repro_torch.core import torch_sched as tsched
from repro_torch.kernels.flash_attention import flash_attention as port_fa

ALL_TECHNIQUES = tuple(REGISTRY)
SPEC_VARIANTS = ALL_TECHNIQUES + ("fac2,4", "gss,2", "ss,8", "static,4")
COSTS = np.random.default_rng(11).integers(1, 65, 47).astype(float)
WEIGHTS = np.array([0.5, 1.0, 1.5, 1.0, 2.0])


def assert_plans_equal(a, b):
    np.testing.assert_array_equal(a.order, b.order)
    assert a.order.dtype == b.order.dtype
    np.testing.assert_array_equal(a.step_worker, b.step_worker)
    np.testing.assert_array_equal(a.step_cost, b.step_cost)
    np.testing.assert_array_equal(a.worker_cost, b.worker_cost)
    assert (a.p, a.n, a.n_chunks, a.sched_time) == (
        b.p, b.n, b.n_chunks, b.sched_time)
    assert str(a.spec) == str(b.spec)
    assert (a.t_par, a.cov, a.percent_imbalance) == (
        b.t_par, b.cov, b.percent_imbalance)
    ra, rb = a.to_record("k", instance=2), b.to_record("k", instance=2)
    assert ra.to_dict() == rb.to_dict()
    for sa, sb in zip(a.shares(), b.shares()):
        np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("weights", [None, "w"])
@pytest.mark.parametrize("overhead", [0.0, 0.5])
@pytest.mark.parametrize("assign", ["greedy", "round_robin"])
@pytest.mark.parametrize("technique", SPEC_VARIANTS)
def test_kernel_tile_plan_identical(technique, assign, overhead, weights):
    w = WEIGHTS if weights else None
    a = tsched.plan_tiles_for_kernel(COSTS, p=5, technique=technique,
                                     assign=assign, weights=w,
                                     overhead_per_chunk=overhead)
    b = jsched.plan_tiles_for_kernel(COSTS, p=5, technique=technique,
                                     assign=assign, weights=w,
                                     overhead_per_chunk=overhead)
    assert_plans_equal(a, b)


def test_plan_edge_cases_match_reference():
    assert_plans_equal(tsched.plan_tiles_for_kernel([], p=4),
                       jsched.plan_tiles_for_kernel([], p=4))
    fn = lambda c: c * 10  # noqa: E731
    assert_plans_equal(tsched.plan_tiles_for_kernel([1.0, 2.0, 3.0], p=2,
                                                    cost_fn=fn),
                       jsched.plan_tiles_for_kernel([1.0, 2.0, 3.0], p=2,
                                                    cost_fn=fn))
    for kw, match in (({"assign": "nope"}, "assign"),
                      ({"weights": [1.0, 1.0, 1.0]}, "weights"),
                      ({"weights": [0.0, 0.0]}, "positive sum")):
        with pytest.raises(ValueError, match=match):
            tsched.plan_tiles_for_kernel([1.0, 2.0], p=2, **kw)
    with pytest.raises(ValueError, match="1-D"):
        tsched.plan_tiles_for_kernel(np.ones((2, 2)), p=2)


def _cache_trace(mod):
    """The hit/miss/bypass counters after the reference's cache scenario."""
    mod.kernel_plan_cache_clear()
    rng = np.random.default_rng(5)
    costs = rng.integers(1, 40, 16).astype(float)
    w = np.array([1.0, 1.0, 0.5, 1.5])
    trace = []
    a = mod.plan_tiles_cached(costs, p=4, technique="fac2")
    trace.append(mod.plan_tiles_cached(costs.copy(), p=4,
                                       technique="fac2") is a)
    trace.append(mod.plan_tiles_cached(costs, p=8, technique="fac2") is a)
    trace.append(mod.plan_tiles_cached(costs[:-1], p=4, technique="fac2") is a)
    b = mod.plan_tiles_cached(costs, p=4, technique="fac2", weights=w)
    trace.append(mod.plan_tiles_cached(costs, p=4, technique="fac2",
                                       weights=w * (1 + 1e-4)) is b)
    trace.append(mod.plan_tiles_cached(
        costs, p=4, technique="fac2", weights=w[::-1].copy()) is b)
    mod.plan_tiles_cached(costs, p=4, cost_fn=lambda c: c * 2.0)
    stats = mod.kernel_plan_cache_stats()
    mod.kernel_plan_cache_clear()
    return trace, stats


def test_plan_cache_counters_match_reference():
    assert _cache_trace(tsched) == _cache_trace(jsched)


@pytest.mark.parametrize("spec", ("fac2", "gss,2", "awf_b"))
def test_plan_cache_returns_the_uncached_plan(spec):
    tsched.kernel_plan_cache_clear()
    assert_plans_equal(tsched.plan_tiles_cached(COSTS, p=4, technique=spec),
                       jsched.plan_tiles_for_kernel(COSTS, p=4,
                                                    technique=spec))
    tsched.kernel_plan_cache_clear()


@pytest.mark.parametrize("technique", SPEC_VARIANTS)
def test_worker_bounds_cover_the_shares(technique):
    plan = tsched.plan_tiles_for_kernel(COSTS, p=5, technique=technique)
    b = tsched.worker_bounds(plan.step_worker, plan.p)
    assert b[0] == 0 and b[-1] == plan.n and (np.diff(b) >= 0).all()
    for w, share in enumerate(plan.shares()):
        np.testing.assert_array_equal(plan.order[b[w]:b[w + 1]], share)


# ---------------------------------------------------------------------------
# MoE tile planner and balancer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,block,cap", [
    ([32, 8, 16, 24], 8, None), ([5, 12], 8, 16), ([0, 40, 3, 17], 8, 40),
    ([128, 0, 0, 7, 64], 16, 128)])
@pytest.mark.parametrize("technique", ALL_TECHNIQUES)
def test_moe_plan_tiles_identical(technique, rows, block, cap):
    rows = np.asarray(rows)
    a, pa = port_moe.plan_tiles(rows, block, p=4, technique=technique,
                                capacity_rows=cap, return_plan=True)
    b, pb = ref_moe.plan_tiles(rows, block, p=4, technique=technique,
                               capacity_rows=cap, return_plan=True)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype
    assert_plans_equal(pa, pb)


@pytest.mark.parametrize("schedule", ("awf", "awf_b,1,adapt=3", "af"))
@pytest.mark.parametrize("recency", (True, False))
def test_moe_balancer_bias_trajectory_identical(schedule, recency):
    rng = np.random.default_rng(7)
    a = port_moe.MoEBalancer(num_experts=6, schedule=schedule,
                             recency=recency, kernel_schedule="gss,2")
    b = ref_moe.MoEBalancer(num_experts=6, schedule=schedule,
                            recency=recency, kernel_schedule="gss,2")
    for _ in range(9):
        load = rng.integers(0, 50, 6)
        np.testing.assert_array_equal(a.update(load), b.update(load))
        np.testing.assert_array_equal(a.weights, b.weights)
    rows = rng.integers(0, 33, 6)
    oa, pa = a.plan_kernel_tiles(rows, block_rows=8, p=3,
                                 worker_weights=[1.0, 0.5, 2.0])
    ob, pb = b.plan_kernel_tiles(rows, block_rows=8, p=3,
                                 worker_weights=[1.0, 0.5, 2.0])
    np.testing.assert_array_equal(oa, ob)
    assert_plans_equal(pa, pb)
    assert [r.to_dict() for r in a.kernel_recorder.records] == [
        r.to_dict() for r in b.kernel_recorder.records]


def test_moe_balancer_rejects_non_adaptive():
    with pytest.raises(ValueError, match="adaptive"):
        port_moe.MoEBalancer(num_experts=4, schedule="fac2")


# ---------------------------------------------------------------------------
# flash-attention descriptor planner
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # bh, s, block_q, block_k, causal, window, kv_lens
    (2, 160, 64, 64, True, 0, None),
    (4, 130, 32, 32, True, 0, [33, 130, 0, 200]),
    (2, 160, 32, 32, True, 48, None),
    (3, 100, 32, 16, False, 0, [1, 64, 99]),
    (3, 300, 128, 64, True, 40, [0, 300, 129]),
    (2, 256, 64, 64, False, 70, [256, 0]),
    (2, 4096, 512, 512, True, 0, [4096, 700]),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kv_group_costs_identical(case):
    bh, s, bq, bk, causal, window, lens = case
    lens = None if lens is None else np.asarray(lens)
    ka, ca, la = port_fa.flash_kv_group_costs(bh, s, bq, bk, causal=causal,
                                              window=window, kv_lens=lens)
    kb, cb, lb = ref_fa.flash_kv_group_costs(bh, s, bq, bk, causal=causal,
                                             window=window, kv_lens=lens)
    assert ka == kb
    np.testing.assert_array_equal(ca, cb)
    assert ca.dtype == cb.dtype
    np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("technique", SPEC_VARIANTS)
@pytest.mark.parametrize("case", FLASH_CASES[:-1])
def test_flash_descriptors_identical(case, technique):
    bh, s, bq, bk, causal, window, lens = case
    lens = None if lens is None else np.asarray(lens)
    kw = dict(causal=causal, window=window, kv_lens=lens, schedule=technique,
              p=3)
    da, pa = port_fa._plan_kv_descriptors(bh, s, bq, bk, **kw)
    db, pb = ref_fa._plan_kv_descriptors(bh, s, bq, bk, **kw)
    for x, y in zip(da, db):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype == np.int32
    assert_plans_equal(pa, pb)
    # CTA w runs exactly the triples of its plan share, whole groups only
    bounds = port_fa.descriptor_bounds(da, pa)
    nq = -(-s // bq)
    for w, share in enumerate(pa.shares()):
        lo, hi = bounds[w], bounds[w + 1]
        starts = np.flatnonzero(da[3][lo:hi]) + lo
        np.testing.assert_array_equal(da[0][starts] * nq + da[1][starts],
                                      share)
        assert hi == lo or (da[3][lo] == 1 and da[4][hi - 1] == 1)
