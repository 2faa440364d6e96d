"""Parity of the port's auto-selector (``repro_torch.core.auto``, a NumPy
copy whose graph engine is the port's torch campaign engine) with the JAX
package's on the CPU: the bandit's choices under the same rewards, and
``auto_simulate``'s arm sequences, per-step times and final statistics
for the event, batch and graph engines.  Exact throughout: the graph
engine is bit-exact at p < 8 (``tests/test_torch_graph_sim.py``), and the
selector sees the same floats.

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

import numpy as np
import pytest

import repro.core as ref
from repro.core.auto import DEFAULT_CANDIDATES as REF_DEFAULTS
import repro_torch.core as port
from repro_torch.core.auto import DEFAULT_CANDIDATES


def _history(h):
    return [(x["step"], x["technique"], x["t_par"], x["pi"]) for x in h]


def test_selector_choices_match_reference():
    assert DEFAULT_CANDIDATES == REF_DEFAULTS
    rng = np.random.default_rng(0)
    for policy, steps in (("ucb", 1), ("explore_commit", 2)):
        for cands in (DEFAULT_CANDIDATES, ("fac2,64", "fac2,512", "gss")):
            a = port.AutoSelector(candidates=cands, policy=policy,
                                  explore_steps=steps)
            b = ref.AutoSelector(candidates=cands, policy=policy,
                                 explore_steps=steps)
            for _ in range(40):
                ca, cb = a.choose(), b.choose()
                assert str(ca) == str(cb)
                t = float(rng.uniform(0.5, 2.0))
                a.record(ca, t)
                b.record(cb, t)
            assert a.summary() == b.summary()
            assert str(a.best) == str(b.best)
    with pytest.raises(KeyError):
        port.AutoSelector(candidates=("gss", "not_a_technique"))
    with pytest.raises(ValueError, match="duplicate"):
        port.AutoSelector(candidates=("gss", "gss"))


def _builtin_names():
    """The techniques ``src/repro`` itself registers.  Other test files
    (``test_lint.py``, ``test_schedule.py``) register plugins into the
    reference's live REGISTRY, and an xdist worker may have run them
    first; only the built-in set is the port's to match."""
    return [n for n in ref.REGISTRY
            if ref.REGISTRY[n].cls.__module__.startswith("repro.")]


def test_registry_candidates_match_reference():
    builtin = _builtin_names()
    # a technique missing from the port, or one it has in excess, fails
    assert list(port.REGISTRY) == builtin
    for cp, excl in ((None, ()), (8, ("rand",)), (3, ("ws_rr", "AWF-B"))):
        a = port.registry_candidates(chunk_param=cp, exclude=excl)
        b = ref.registry_candidates(chunk_param=cp, exclude=excl)
        b = [x for x in b if x.technique in builtin]
        assert [str(x) for x in a] == [str(x) for x in b]


def test_auto_simulate_event_and_batch_arms_match_reference():
    w, rw = port.sphynx_like(n=6000), ref.sphynx_like(n=6000)
    speeds = np.ones(8)
    speeds[:2] = 1.7
    cands = ("static", "gss", "fac2", "awf_b", "af")
    for policy, explore in (("ucb", 1), ("explore_commit", 2)):
        for engine in ("event", "batch"):
            kw = dict(p=8, timesteps=14, chunk_param=4, speeds=speeds,
                      seed=5, engine=engine)
            sa, ha = port.auto_simulate(
                w, selector=port.AutoSelector(cands, policy, explore),
                profile=port.NOISY_PROFILE, **kw)
            sb, hb = ref.auto_simulate(
                rw, selector=ref.AutoSelector(cands, policy, explore),
                profile=ref.NOISY_PROFILE, **kw)
            assert _history(ha) == _history(hb), (policy, engine)
            assert sa.summary() == sb.summary()
    with pytest.raises(ValueError, match="engine"):
        port.auto_simulate(w, p=2, timesteps=1, engine="warp")


def test_auto_simulate_graph_engine_matches_reference_and_batch():
    """engine="graph" on the CPU: the adaptive arms run on the torch
    campaign engine, and the arm sequence, every step's t_par and the final
    choice equal the reference's graph engine and the port's batch engine
    (p = 6 < 8: bit-exact)."""
    w, rw = port.sphynx_like(n=5000), ref.sphynx_like(n=5000)
    speeds = np.ones(6)
    speeds[:2] = 1.5
    arms = port.registry_candidates(chunk_param=4)
    builtin = _builtin_names()
    steps = len(arms) + 4
    kw = dict(p=6, timesteps=steps, speeds=speeds)
    for policy in ("explore_commit", "ucb"):
        sg, hg = port.auto_simulate(
            w, selector=port.AutoSelector(arms, policy), engine="graph",
            device="cpu", **kw)
        if policy == "ucb":   # its one grid call: the exploration prefix
            assert port.graph_sim.LAST_RUN["lanes"] > 0
        ref_arms = [x for x in ref.registry_candidates(chunk_param=4)
                    if x.technique in builtin]
        sr, hr = ref.auto_simulate(
            rw, selector=ref.AutoSelector(tuple(ref_arms), policy), engine="graph",
            **kw)
        sb, hb = port.auto_simulate(
            w, selector=port.AutoSelector(arms, policy), engine="batch", **kw)
        assert _history(hg) == _history(hr) == _history(hb), policy
        assert str(sg.best) == str(sr.best) == str(sb.best)
