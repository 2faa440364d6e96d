"""The port's ``serve/elastic.py`` and ``RequestScheduler.neutralize_worker``
against the reference's, on the CPU.

Both packages get the same seeded telemetry; every technique state they
end in (weights, telemetry windows, AF / BOLD statistics), every moved
backlog and every pull sequence must be equal, exactly."""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest

import repro.core as ref_core
import repro.serve.elastic as ref_elastic
import repro.serve.scheduler as ref_scheduler
import repro_torch.core as port_core
import repro_torch.serve.elastic as port_elastic
import repro_torch.serve.scheduler as port_scheduler

PACKAGES = {"ref": (ref_core, ref_elastic, ref_scheduler),
            "port": (port_core, port_elastic, port_scheduler)}


def _state(obj) -> str:
    """Every plain attribute of ``obj`` (arrays as dtype + values), as a
    string: equal strings mean equal state, NaNs included."""
    out = {}
    for k, v in sorted(vars(obj).items()):
        if isinstance(v, np.ndarray):
            out[k] = (str(v.dtype), v.tolist())
        elif isinstance(v, np.generic):
            out[k] = v.item()
        elif isinstance(v, (int, float, str, bool, type(None))):
            out[k] = v
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, (int, float, str, bool)) for x in v):
            out[k] = list(v)
        else:
            out[k] = type(v).__name__
    return repr(out)


def _both(fn):
    """``fn(core, elastic, scheduler)`` on both packages; assert the two
    results equal and return the port's."""
    got = {name: fn(*mods) for name, mods in PACKAGES.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def _train(tech, p, speeds, rounds=4):
    for i in range(rounds * p):
        w = i % p
        g = tech.next_chunk(w)
        if g is None:
            break
        tech.complete_chunk(w, g, exec_time=g.size * speeds[w],
                            sched_time=1e-6)
    return tech


def _reqs(sched_mod, n, seed=0):
    rng = np.random.default_rng(seed)
    return [sched_mod.Request(rid=i, arrival=0.0,
                              prompt_len=int(rng.integers(8, 64)),
                              max_new_tokens=int(rng.integers(4, 48)))
            for i in range(n)]


def _loaded(sched_mod, technique, p=4, n=2400, rounds=3):
    s = sched_mod.RequestScheduler(num_workers=p, technique=technique)
    for r in _reqs(sched_mod, n):
        s.submit(r)
    for _ in range(rounds):
        for w in range(p):
            chunk = s.pull(w)
            s.complete(w, elapsed=len(chunk) * (1.0 + 0.5 * w) * 1e-3)
    return s


def _drain(s):
    served, w = [], 0
    while True:
        chunk = s.pull(w % s.num_workers)
        if not chunk:
            return served
        served.append([r.rid for r in chunk])
        s.complete(w % s.num_workers, elapsed=len(chunk) * (1.0 + w % 3))
        w += 1


def test_neutralize_worker_state_matches_reference():
    cases = [(t, p, picked) for t in ("awf_b", "awf_c", "awf_d", "awf",
                                      "af", "bold", "fac2", "static")
             for p, picked in ((4, [2]), (6, [0, 5]), (3, [0, 1, 2]),
                               (4, [9]))]

    def run(core, elastic, _):
        out = []
        for technique, p, picked in cases:
            tech = core.make_technique(technique, n=3000, p=p)
            tech.begin_instance(0)
            _train(tech, p, speeds=1e-3 * (1.0 + np.arange(p)))
            before = _state(tech)
            changed = elastic.neutralize_worker_state(tech, picked)
            out.append((technique, p, changed, before, _state(tech)))
        return out

    got = _both(run)
    # the adaptive weights were in fact reset, and a no-op stays one
    assert any(c and a != b for _, _, c, a, b in got)
    assert all(a == b for t, _, c, a, b in got if t in ("fac2", "static"))


def test_resize_scheduler_matches_reference():
    cases = [(t, p) for t in ("awf_b", "af", "bold", "fac2")
             for p in (2, 4, 6)]

    def run(_, elastic, sched_mod):
        out = []
        for technique, new_p in cases:
            s = _loaded(sched_mod, technique)
            s.pull(0)  # an open grant, dropped by the resize
            s2 = elastic.resize_scheduler(s, new_p)
            moved = [r.rid for r in s2._pending[s2._head:]]
            head = (s2.num_workers, s2.backlog, s2._plan_gen,
                    s2._force_replan, sorted(s2._outstanding))
            first = [r.rid for r in s2.pull(0)]
            plan = _state(s2._tech)
            out.append((technique, new_p, moved, head, first, plan,
                        _drain(s2), _state(s2._tech)))
        with pytest.raises(ValueError):
            elastic.resize_scheduler(_loaded(sched_mod, "fac2"), 0)
        return out

    got = _both(run)
    assert all(head[3] for _, _, _, head, *_ in got)


def test_elastic_handoff_matches_reference():
    cases = [dict(), dict(n=500, old_p=4, new_p=6, technique="awf_c"),
             dict(n=2000, old_p=8, new_p=2, technique="af", chunks_done=5),
             dict(n=800, old_p=3, new_p=3, technique="bold")]

    def run(_, elastic, __):
        out = []
        for kw in cases:
            plan, old, new = elastic.elastic_handoff(**kw)
            chunks = [(c.worker, c.start, c.size, c.batch)
                      for c in plan.chunks]
            out.append((plan.n, plan.p, chunks, _state(old), _state(new)))
        return out

    _both(run)


def test_neutralize_worker_pull_sequences_match_reference():
    def run(_, __, sched_mod):
        out = []
        for technique, p, slow in (("awf_c", 3, 2), ("awf_b", 4, 1),
                                   ("af", 2, 1), ("fac2", 3, 0)):
            s = sched_mod.RequestScheduler(num_workers=p, technique=technique)
            for r in _reqs(sched_mod, 60):
                s.submit(r)
            seq = []
            for rnd in range(6):
                if rnd == 3:
                    s.neutralize_worker(slow)
                    for r in _reqs(sched_mod, 40, seed=1):
                        s.submit(r)
                for w in range(p):
                    chunk = s.pull(w)
                    seq.append((w, [r.rid for r in chunk]))
                    if chunk:
                        cost = sum(r.cost for r in chunk)
                        s.complete(w, elapsed=cost * (30.0 if w == slow
                                                      else 1.0))
            with pytest.raises(ValueError):
                s.neutralize_worker(p)
            out.append((technique, seq, _state(s._tech)))
        return out

    _both(run)
