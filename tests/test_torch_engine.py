"""The port's DecodeEngine (``repro_torch.serve``) against the reference's,
on the CPU: the runs of tests/test_engine.py on both packages.

fp32 smoke qwen3-4b, and for the lane-reuse cases fp32 smoke xlstm-1.3b
(recurrent states) and granite-moe-1b-a400m (MoE FFN); parameters from the
reference's ``init_decoder`` through ``repro_torch.convert``.  Every run
must give, exactly: the greedy tokens per request, the ``EngineStats``
counters, the shed requests, the ``decode_kv`` plan records, the
scheduler's pull sequence, the chunk measurements reported back to it, the
plan-cache counters, and the state of every lane right after the engine
resets it for reuse (a fresh single-lane state: zero KV caches and
positions, the mLSTM / sLSTM stabiliser m at -1e30).  The fp32 logits of
the two packages differ by about 1e-7 (tests/test_torch_models.py), far
below the gaps greedy decoding picks between on these runs.

The reset state is compared directly because the greedy tokens cannot
show a wrong stabiliser: m is a log-space scale that cancels in the
normalised mLSTM / sLSTM readouts, so a lane reset to m = 0 decodes the
same tokens up to rounding, while its state differs from the reference's.
"""

import dataclasses

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, smoke_config as ref_smoke
from repro.core import jax_sched
from repro.models import init_decoder
from repro.serve.engine import DecodeEngine as RefEngine
from repro.serve.scheduler import Request as RefRequest
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import decoder_params_from_jax
from repro_torch.core import torch_sched
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.scheduler import Request


def _models(arch):
    kw = dict(prefix_len=0, compute_dtype="float32")
    cfg = dataclasses.replace(ref_smoke(REF_ARCHS[arch]), **kw)
    tcfg = dataclasses.replace(smoke_config(ARCHS[arch]), **kw)
    params, _ = init_decoder(jax.random.key(0), cfg)
    tparams = decoder_params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    return {"ref": (RefEngine, RefRequest, cfg, params, {}),
            "port": (DecodeEngine, Request, tcfg, tparams, {"device": "cpu"})}


@pytest.fixture(scope="module")
def models():
    return _models("qwen3-4b")


@pytest.fixture(scope="module",
                params=("xlstm-1.3b", "granite-moe-1b-a400m"))
def family_models(request):
    return _models(request.param)


def _lane_state(state, s):
    """Lane ``s`` of every cache tensor and its position, as float lists."""
    leaves = ([t[:, s] for c in state.group_caches for t in c]
              + [t[s] for c in state.rem_caches for t in c] + [state.pos[s]])
    return [(x.float().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x, np.float32)).tolist() for x in leaves]


def _run_both(models, scenario, **engine_kw):
    """Run ``scenario(make_engine, make_request)`` on both packages; assert
    every observable equal and return the port's observables."""
    seen = {}
    for pkg, (engine_cls, req_cls, cfg, params, extra) in models.items():
        jax_sched.kernel_plan_cache_clear()
        torch_sched.kernel_plan_cache_clear()
        engines = []

        def make_engine(**kw):
            eng = engine_cls(cfg, params, **{**engine_kw, **kw}, **extra)
            eng.pulls, eng.reported = [], []
            pull, complete = eng.sched.pull, eng.sched.complete

            def spy_pull(worker, eng=eng, pull=pull):
                out = pull(worker)
                eng.pulls.append((worker, [r.rid for r in out]))
                return out

            def spy_complete(worker, elapsed, eng=eng, complete=complete):
                eng.reported.append((worker, elapsed))
                complete(worker, elapsed=elapsed)

            eng.sched.pull, eng.sched.complete = spy_pull, spy_complete
            eng.resets = []
            reset = eng._reset_lane

            def spy_reset(s, eng=eng, reset=reset):
                reset(s)
                eng.resets.append((s, _lane_state(eng.state, s)))

            eng._reset_lane = spy_reset
            engines.append(eng)
            return eng

        def make_request(rid, prompt_len=6, new=8):
            return req_cls(rid=rid, arrival=0.0, prompt_len=prompt_len,
                           max_new_tokens=new)

        stats = scenario(make_engine, make_request)
        seen[pkg] = {
            "stats": [(s.completed, s.steps, s.tokens, s.shed) for s in stats],
            "outputs": [dict(e._outputs) for e in engines],
            "shed_rids": [list(e.shed_rids) for e in engines],
            "records": [[r.to_dict() for r in e.kernel_records]
                        for e in engines],
            "pulls": [e.pulls for e in engines],
            "reported": [e.reported for e in engines],
            "plans": [(e.plan_calls, e.plan_cache_hits) for e in engines],
            "backlog": [e.sched.backlog for e in engines],
            "resets": [e.resets for e in engines],
        }
    for key, want in seen["ref"].items():
        assert seen["port"][key] == want, key
    return seen["port"]


def test_engine_completes_all_requests(models):
    def scenario(engine, req):
        eng = engine(slots=4, max_len=64)
        for i in range(10):
            eng.submit(req(i))
        return [eng.run()]

    got = _run_both(models, scenario)
    assert got["stats"][0][0] == 10
    vocab = models["port"][2].padded_vocab
    for out in got["outputs"][0].values():
        assert len(out) == 8 and all(0 <= t < vocab for t in out)


def test_engine_lane_isolation(models):
    prompt = [int(t) for t in np.random.default_rng(7).integers(2, 200, 6)]
    first = [int(t) for t in np.random.default_rng(3).integers(2, 200, 10)]

    def scenario(engine, req):
        alone = engine(slots=1, max_len=64)
        alone.submit(req(100), prompt=list(prompt))
        seq = engine(slots=1, max_len=64)
        seq.submit(req(99), prompt=list(first))
        seq.submit(req(100), prompt=list(prompt))
        return [alone.run(), seq.run()]

    got = _run_both(models, scenario)
    assert got["outputs"][1][100] == got["outputs"][0][100]


def test_engine_reused_lanes_match_on_other_families(family_models):
    """More requests than slots, so lanes are reset and reused: a reused
    lane must start from a fresh state (the mLSTM / sLSTM stabiliser m at
    -1e30, not 0) for the tokens to match the reference's."""
    def scenario(engine, req):
        eng = engine(slots=2, max_len=64)
        for i in range(6):
            eng.submit(req(i, new=6))
        return [eng.run()]

    got = _run_both(family_models, scenario)
    assert got["stats"][0][:3:2] == (6, 36)
    assert len(got["resets"][0]) == 4


def test_engine_lane_isolation_on_other_families(family_models):
    """A request decodes the same alone as on a lane another request used."""
    prompt = [int(t) for t in np.random.default_rng(7).integers(2, 200, 6)]
    first = [int(t) for t in np.random.default_rng(3).integers(2, 200, 10)]

    def scenario(engine, req):
        alone = engine(slots=1, max_len=64)
        alone.submit(req(100), prompt=list(prompt))
        seq = engine(slots=1, max_len=64)
        seq.submit(req(99), prompt=list(first))
        seq.submit(req(100), prompt=list(prompt))
        return [alone.run(), seq.run()]

    got = _run_both(family_models, scenario)
    assert got["outputs"][1][100] == got["outputs"][0][100]


@pytest.mark.parametrize("technique", ("gss", "fac2", "static", "awf_b"))
def test_engine_dls_admission_pulls_chunks(models, technique):
    def scenario(engine, req):
        eng = engine(slots=2, max_len=64, technique=technique)
        for i in range(6):
            eng.submit(req(i, new=4))
        return [eng.run()]

    got = _run_both(models, scenario)
    assert got["stats"][0][:3:2] == (6, 24)


def test_engine_reports_chunk_service_times(models):
    def scenario(engine, req):
        eng = engine(slots=2, max_len=64, technique="awf_c")
        for i in range(6):
            eng.submit(req(i, new=4))
        return [eng.run()]

    got = _run_both(models, scenario)
    assert got["reported"][0] and all(e > 0 for _, e in got["reported"][0])


def test_engine_plans_only_on_admission_change(models):
    def scenario(engine, req):
        eng = engine(slots=2, max_len=64)
        for i in range(8):
            eng.submit(req(i, prompt_len=4, new=4))
        return [eng.run()]

    got = _run_both(models, scenario)
    (calls, hits), = got["plans"]
    assert calls == len(got["records"][0]) and hits > 0
    assert [r["instance"] for r in got["records"][0]] == list(range(calls))


def test_engine_slot_disable_mid_stream(models):
    def scenario(engine, req):
        eng = engine(slots=3, max_len=64)
        for i in range(9):
            eng.submit(req(i, new=4))
        first = eng.run(max_steps=4)   # mid-prefill on all three lanes
        eng.set_slot_enabled(1, False)
        return [first, eng.run()]

    got = _run_both(models, scenario)
    assert got["stats"][0][0] + got["stats"][1][0] == 9
    assert all(len(out) == 4 for out in got["outputs"][0].values())


def test_engine_all_slots_disabled_terminates(models):
    def scenario(engine, req):
        eng = engine(slots=2, max_len=64)
        for i in range(4):
            eng.submit(req(i, new=4))
        eng.set_slot_enabled(0, False)
        eng.set_slot_enabled(1, False)
        stalled = eng.run()
        eng.set_slot_enabled(0, True)
        return [stalled, eng.run()]

    got = _run_both(models, scenario)
    assert got["stats"][0][0] == 0 and got["stats"][1][0] == 4


def test_engine_disabled_slot_drops_partial_measurement(models):
    def scenario(engine, req):
        eng = engine(slots=2, max_len=64, technique="awf_c")
        for i in range(6):
            eng.submit(req(i, new=4))
        first = eng.run(max_steps=3)
        before = list(eng.reported)
        eng.set_slot_enabled(0, False)
        assert eng.reported == before   # disable itself reported nothing
        return [first, eng.run()]

    got = _run_both(models, scenario)
    assert 1 in [w for w, _ in got["reported"][0]]


@pytest.mark.parametrize("slo,disable", [(30.0, False), (40.0, False),
                                         (40.0, True), (None, False)])
def test_engine_shedding_matches(models, slo, disable):
    def scenario(engine, req):
        eng = engine(slots=2, max_len=64, shed_slo=slo)
        if disable:
            eng.set_slot_enabled(1, False)
        for i in range(10):
            eng.submit(req(i, prompt_len=6, new=8))
        return [eng.run()]

    got = _run_both(models, scenario)
    completed, _, _, shed = got["stats"][0]
    assert completed + shed == 10
    assert (shed > 0) == (slo is not None)
    assert len(got["shed_rids"][0]) == shed and 0 not in got["shed_rids"][0]


def test_sampled_decoding_is_seeded(models):
    """Sampling from one seed gives the same tokens twice, all in the
    vocabulary (the reference's tokens: test_torch_random.py)."""
    _, _, tcfg, tparams, _ = models["port"]

    def sample(seed):
        eng = DecodeEngine(tcfg, tparams, slots=2, max_len=64, greedy=False,
                           temperature=0.7, seed=seed, device="cpu")
        for i in range(4):
            eng.submit(Request(rid=i, arrival=0.0, prompt_len=5,
                               max_new_tokens=6))
        assert eng.run().completed == 4
        return [eng.output(i) for i in range(4)]

    first = sample(1)
    assert sample(1) == first
    assert all(len(out) == 6 and all(0 <= t < tcfg.padded_vocab for t in out)
               for out in first)
