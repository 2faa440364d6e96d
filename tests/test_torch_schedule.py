"""Parity of the port's chunk calculus (``repro_torch.core``) with the JAX
reference (``repro.core``): registry, ScheduleSpec resolution, planner and
metrics give identical results.  Also the port's package rules: no JAX or
``repro`` import anywhere in ``src/repro_torch`` or ``chip_smoke.py``, and
``resolve_device`` refuses to fall back to the CPU.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch.device import check_device, resolve_device

ROOT = Path(__file__).resolve().parents[1]
TECHNIQUES = tuple(port.REGISTRY)
PLAN_CASES = ((100, 4, 1), (1000, 8, 1), (257, 3, 5), (64, 16, 2))


def _chunks(plan):
    return [(c.worker, c.start, c.size, c.batch) for c in plan.chunks]


def test_registry_names_and_order_match_reference():
    assert list(port.REGISTRY) == list(ref.REGISTRY)
    assert len(port.REGISTRY) == 27


@pytest.mark.parametrize("name", TECHNIQUES)
def test_registry_metadata_matches_reference(name):
    pe, re_ = port.REGISTRY[name], ref.REGISTRY[name]
    assert dataclasses.asdict(pe.meta) == dataclasses.asdict(re_.meta)
    assert pe.paper_set == re_.paper_set
    assert pe.cls.__name__ == re_.cls.__name__
    assert (pe.step_batch is None) == (re_.step_batch is None)
    assert (pe.techdef is None) == (re_.techdef is None)


def test_registry_views_match_reference():
    for view in ("ADAPTIVE_TECHNIQUES", "NONADAPTIVE_TECHNIQUES",
                 "PROFILING_TECHNIQUES", "PAPER_LB4OMP_SET"):
        assert tuple(getattr(port, view)) == tuple(getattr(ref, view)), view
    assert port.STEAL_TECHNIQUES == ref.STEAL_TECHNIQUES


@pytest.mark.parametrize("text", ["fac2", "fac2,64", "AWF-B,8,adapt=4",
                                  "dynamic,4", "guided", "gss,1,backend=host",
                                  "dls+steal"])
def test_spec_parse_matches_reference(text):
    a, b = port.ScheduleSpec.parse(text), ref.ScheduleSpec.parse(text)
    assert (a.technique, a.chunk_param, a.adapt_every, a.backend) == (
        b.technique, b.chunk_param, b.adapt_every, b.backend)
    assert str(a) == str(b)


def test_runtime_reads_lb_schedule(monkeypatch):
    monkeypatch.setenv(port.LB_SCHEDULE_ENV, "gss,3")
    assert port.resolve("runtime") == port.ScheduleSpec("gss", 3)
    assert str(port.resolve(None)) == str(ref.resolve(None))
    monkeypatch.delenv(port.LB_SCHEDULE_ENV)
    with pytest.raises(ValueError, match="unset"):
        port.resolve("runtime")
    assert port.resolve(None, default="tss").technique == "tss"


def test_unknown_technique_lists_valid_names():
    with pytest.raises(KeyError, match="known"):
        port.ScheduleSpec.parse("nope")


@pytest.mark.parametrize("n,p,cp", PLAN_CASES)
@pytest.mark.parametrize("name", TECHNIQUES)
def test_plan_schedule_chunks_identical(name, n, p, cp):
    a = port.plan_schedule(name, n, p, chunk_param=cp)
    b = ref.plan_schedule(name, n, p, chunk_param=cp)
    assert _chunks(a) == _chunks(b)
    assert (a.technique, a.n, a.p, a.chunk_param) == (
        b.technique, b.n, b.p, b.chunk_param)
    a.validate()
    np.testing.assert_array_equal(a.worker_loads(), b.worker_loads())


@pytest.mark.parametrize("name", ("fac2", "awf_b", "ws_rp", "static"))
def test_replan_identical(name):
    a = port.replan(port.plan_schedule(name, 500, 8), new_p=5,
                    done_iterations=123)
    b = ref.replan(ref.plan_schedule(name, 500, 8), new_p=5,
                   done_iterations=123)
    assert _chunks(a) == _chunks(b) and a.p == b.p == 5


def test_graph_backend_waits_for_the_closed_forms(monkeypatch):
    """backend="graph" runs the closed forms (torch_sched.plan_chunks): on
    the CPU when asked, equal to the reference's graph plan; by default on
    the card, so without one it raises rather than fall back."""
    a = port.plan_schedule("gss,1,backend=graph", 100, 4, device="cpu")
    assert _chunks(a) == _chunks(ref.plan_schedule("gss,1,backend=graph",
                                                   100, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.plan_schedule("gss,1,backend=graph", 100, 4)


def test_metrics_identical():
    rng = np.random.default_rng(3)
    for t in (rng.random(8), np.zeros(4), np.array([5.0]), np.array([])):
        assert port.cov(t) == ref.cov(t)
        assert port.percent_imbalance(t) == ref.percent_imbalance(t)
    rec_p, rec_r = port.LoopRecorder(), ref.LoopRecorder()
    for rec, mod in ((rec_p, port), (rec_r, ref)):
        for i in range(3):
            rec.add(mod.LoopInstanceRecord(
                loop="l", technique="fac2", instance=rec.next_instance("l"),
                p=2, n=10, chunk_param=1, t_par=float(i + 2),
                thread_times=np.array([1.0, float(i + 2)]),
                thread_finish=np.array([1.0, float(i + 2)]),
                n_chunks=4, sched_time=0.5))
    assert rec_p.summary() == rec_r.summary()
    assert [r.to_dict() for r in rec_p.records] == [
        r.to_dict() for r in rec_r.records]


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro(\.|\s)(?!_torch))", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_never_imports_jax_or_the_reference(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(src), f"{path} imports jax or repro"


def test_resolve_device_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


def test_check_device_dispatch_rules():
    a = torch.zeros(2)
    assert check_device(a, a) == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        check_device(torch.zeros(2, device="meta"))
