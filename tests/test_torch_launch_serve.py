"""``python -m repro_torch.launch.serve`` on the CPU (``--device cpu``) on
the smoke config: it completes every request, with and without the int8
KV cache and with ``--replicas``, draws its request mix as the reference's
launcher does, and its two-level ``run_cluster`` returns the reference's
result and greedy tokens."""

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

from repro_torch.launch import serve


@pytest.mark.parametrize("extra", ([], ["--kv8"], ["--technique", "gss,2"]))
def test_serve_completes_all_requests_on_cpu(capsys, extra):
    rc = serve.main(["--arch", "qwen3-4b", "--requests", "6", "--slots", "2",
                     "--max-len", "32", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert rc == 0
    assert "completed=6/6" in out and "device=cpu" in out


def test_request_mix_is_drawn_as_the_reference_draws_it():
    # src/repro/launch/serve.py draws prompt_len then max_new_tokens per
    # request from default_rng(seed)
    rng = np.random.default_rng(3)
    want = [(int(rng.integers(4, 64 // 4)), int(rng.integers(4, 64 // 4)))
            for _ in range(5)]
    got = serve.make_requests(5, 64, 3)
    assert [(r.prompt_len, r.max_new_tokens) for r in got] == want
    assert [r.rid for r in got] == list(range(5))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _np(x):
    """A torch tensor or a JAX array as a float32 NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _recording_run(monkeypatch, engine_cls, seen):
    """Patch ``engine_cls.run`` to note every engine it runs in ``seen``."""
    run = engine_cls.run

    def recorded(self, *args, **kw):
        stats = run(self, *args, **kw)
        seen[id(self)] = self
        return stats

    monkeypatch.setattr(engine_cls, "run", recorded)


def test_run_cluster_matches_reference(monkeypatch):
    """Two replicas on the smoke qwen3-4b (fp32 compute, so greedy decoding
    picks alike), weights carried across: the port's ``run_cluster``
    returns the reference's dict field for field, every request's greedy
    tokens equal the reference's, and its engines share one prepared copy
    of the weights.  With 8 requests a lane of a re-entered engine decodes
    past ``max_len`` while idle.  Then one engine per package is re-entered
    until a lane that idled past ``max_len`` is admitted for the first
    time, without a reset: the tokens and every cache entry equal the
    reference's, whose cache drops the writes past its end."""
    from repro.configs import ARCHS as REF_ARCHS, smoke_config as ref_smoke
    from repro.core.schedule import resolve as ref_resolve
    from repro.launch import serve as ref_serve
    from repro.models import init_decoder as ref_init
    from repro.serve.engine import DecodeEngine as RefEngine
    from repro.serve.scheduler import Request as RefRequest
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.convert import decoder_params_from_jax
    from repro_torch.core.schedule import resolve
    from repro_torch.models.layers import dtype_of
    from repro_torch.serve.engine import DecodeEngine, prepare_params
    from repro_torch.serve.scheduler import Request

    fp32 = dict(compute_dtype="float32")
    cfg = dataclasses.replace(ref_smoke(REF_ARCHS["qwen3-4b"]), **fp32)
    tcfg = dataclasses.replace(smoke_config(ARCHS["qwen3-4b"]), **fp32)
    params, _ = ref_init(jax.random.key(0), cfg)
    tparams = decoder_params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    kw = dict(replicas=2, slots=2, max_len=32)
    pos = []
    for n in (6, 8):
        reqs = serve.make_requests(n, 32, 0)
        ref_reqs = [RefRequest(rid=r.rid, arrival=r.arrival,
                               prompt_len=r.prompt_len,
                               max_new_tokens=r.max_new_tokens)
                    for r in reqs]
        ref_engines, engines = {}, {}
        _recording_run(monkeypatch, RefEngine, ref_engines)
        _recording_run(monkeypatch, DecodeEngine, engines)
        want = ref_serve.run_cluster(cfg, params, ref_resolve("fac2"),
                                     ref_resolve("awf_b"), requests=ref_reqs,
                                     **kw)
        got = serve.run_cluster(tcfg, tparams, resolve("fac2"),
                                resolve("awf_b"), requests=reqs,
                                device="cpu", **kw)
        monkeypatch.undo()
        assert got == want
        assert got["completed"] == n and len(got["replica_steps"]) == 2
        for r in reqs:
            outs = [[e.output(r.rid) for e in found.values()
                     if e.output(r.rid)]
                    for found in (ref_engines, engines)]
            assert outs[1] == outs[0] and len(outs[1]) == 1, r.rid
        pos += [int(e.state.pos.max()) for e in engines.values()]
    assert max(pos) > 32

    runs = []
    for eng_cls, req_cls, c, p, extra in (
            (RefEngine, RefRequest, cfg, params, {}),
            (DecodeEngine, Request, tcfg, tparams, {"device": "cpu"})):
        eng = eng_cls(c, p, slots=2, max_len=32, technique="static", **extra)
        for rnd in ([(0, 12, 16)], [(1, 12, 16)], [(2, 6, 8), (3, 6, 8)]):
            for rid, prompt, new in rnd:
                eng.submit(req_cls(rid=rid, arrival=0.0, prompt_len=prompt,
                                   max_new_tokens=new))
            assert eng.run().completed == len(rnd)
        runs.append(([eng.output(rid) for rid in range(4)],
                     [int(x) for x in np.asarray(eng.state.pos)],
                     [_np(t) for c in eng.state.group_caches for t in c]))
    (want_out, want_pos, want_kv), (got_out, got_pos, got_kv) = runs
    assert got_out == want_out and got_pos == want_pos
    assert want_pos[1] > 32 + 6 + 8        # admitted past max_len
    for a, b in zip(got_kv, want_kv, strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    shared = prepare_params(tparams, dtype_of(tcfg.compute_dtype),
                            torch.device("cpu"))
    eng = DecodeEngine(tcfg, shared, slots=2, max_len=32, device="cpu")
    pairs = list(zip(_leaves(eng.params), _leaves(shared)))
    assert pairs and all(a is b for a, b in pairs)


def test_replicas_cli_completes_on_cpu(capsys):
    rc = serve.main(["--arch", "qwen3-4b", "--replicas", "2", "--requests",
                     "6", "--slots", "2", "--max-len", "32", "--device",
                     "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "replicas=2" in out and "schedule=awf_b/fac2" in out
    assert "completed=6/6" in out and "cross-node steps c.o.v.=" in out


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-4b", "--requests", "1"])
