"""The port's recurrent mixers (``repro_torch.models.recurrent``), the
causal conv and the recurrent decoders against the JAX reference, on the
CPU.

Smoke configs of ``xlstm-1.3b`` (7 mLSTM + 1 sLSTM) and
``recurrentgemma-2b`` (RG-LRU, RG-LRU, local attention); parameters from
the reference's ``init_decoder`` through ``repro_torch.convert``, inputs
from numpy seeds.  Tolerances:

  * ``causal_conv1d``: 1e-6 on the output (the same taps summed in the same
    order); the new conv state is the inputs' tail, equal.
  * mixers in fp32 (outputs and states): LAYER_ATOL 2e-5, as the
    reference's own unit tests hold the sLSTM and RG-LRU forms to 1e-5 and
    the chunkwise mLSTM to 2e-4.  The port's RG-LRU prefill is a log-step
    scan where the reference runs ``lax.associative_scan``: the same terms
    grouped differently, so the two differ by fp32 rounding.
  * ``forward`` / ``decode_step`` logits in fp32: ATOL 1e-4.
  * in bf16: every logit within 0.25 and the argmax equal at >= 80% of
    positions, the bound ``chip_smoke.py`` holds the card to.  XLA and
    PyTorch round the bf16 projections and gates at different points, and
    the recurrent states carry a difference on from step to step (measured:
    0.02-0.07 at most, 97% argmax agreement).

Cases are looped inside a few tests (each failure names its case) rather
than made parametrize items: with fewer than 12 items this file queues
after tests/test_launch.py in pytest-xdist's loadfile order, whose
``test_shard_as_applies_constraint`` passes only on a worker that has not
started JAX's backend yet (ROADMAP.md, "Faults found").
"""

import dataclasses

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

import repro.models as jm
from repro.configs import ARCHS as REF_ARCHS, smoke_config as ref_smoke
from repro.models import layers as jl
from repro.models import recurrent as jr
import repro_torch.models as tm
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import (decode_state_from_jax,
                                 decoder_params_from_jax, flatten_tree)
from repro_torch.models import layers as tl
from repro_torch.models import recurrent as tr

RECURRENT_ARCHS = ("xlstm-1.3b", "recurrentgemma-2b")
CONV_ATOL = 1e-6
LAYER_ATOL = 2e-5
ATOL = 1e-4
BF16_MAX, BF16_ARGMAX = 0.25, 0.80


def _cfgs(arch, **kw):
    return (dataclasses.replace(ref_smoke(REF_ARCHS[arch]), **kw),
            dataclasses.replace(smoke_config(ARCHS[arch]), **kw))


@pytest.fixture(scope="module")
def models():
    """[(arch, reference params, port params)] for both recurrent archs."""
    out = []
    for arch in RECURRENT_ARCHS:
        cfg, _ = _cfgs(arch)
        params, _ = jm.init_decoder(jax.random.key(0), cfg)
        out.append((arch, params, decoder_params_from_jax(
            jax.tree.map(np.asarray, params), device="cpu")))
    return out


@pytest.fixture(scope="module")
def mixers():
    """{kind: (reference cfg, port cfg, reference params, port params)} for
    one mixer of each recurrent kind, in fp32."""
    out = {}
    for arch, kinds in (("xlstm-1.3b", ("mlstm", "slstm")),
                        ("recurrentgemma-2b", ("rglru",))):
        cfg, tcfg = _cfgs(arch, compute_dtype="float32")
        params, _ = jm.init_decoder(jax.random.key(1), cfg)
        for kind in kinds:
            pi = cfg.block_pattern.index(kind)
            ref = jax.tree.map(lambda a: a[0],
                               params["groups"][pi]["mixer"])
            port = {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
            out[kind] = (cfg, tcfg, ref, port)
    return out


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_states(got, want, atol=LAYER_ATOL):
    assert type(got).__name__ == type(want).__name__
    for field in want._fields:
        np.testing.assert_allclose(_np(getattr(got, field)),
                                   _np(getattr(want, field)), atol=atol,
                                   rtol=1e-5, err_msg=field)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_causal_conv1d_matches():
    for form in ("prefill", "prefill_state", "decode"):
        s = 1 if form == "decode" else 11
        x = _x((2, s, 24), 0)
        w = _x((4, 24), 1)
        state = None if form == "prefill" else _x((2, 3, 24), 2)
        want, want_state = jl.causal_conv1d(
            jnp.asarray(x), jnp.asarray(w),
            None if state is None else jnp.asarray(state))
        got, got_state = tl.causal_conv1d(
            _t(x), _t(w), None if state is None else _t(state))
        np.testing.assert_allclose(_np(got), _np(want), atol=CONV_ATOL,
                                   err_msg=form)
        np.testing.assert_array_equal(_np(got_state), _np(want_state), form)


def test_causal_conv1d_prefill_equals_decode():
    """Prefill and token-by-token decode give the same outputs and the same
    final state."""
    x, w = _t(_x((2, 9, 16), 3)), _t(_x((4, 16), 4))
    y, state = tl.causal_conv1d(x, w)
    st = torch.zeros((2, 3, 16))
    for i in range(9):
        yi, st = tl.causal_conv1d(x[:, i:i + 1], w, st)
        torch.testing.assert_close(yi[:, 0], y[:, i], atol=CONV_ATOL, rtol=0)
    assert torch.equal(st, state)


def test_mlstm_parallel_matches(mixers):
    cfg, tcfg, ref, port = mixers["mlstm"]
    for s, chunk, carry in (
            (23, 8, False),    # s not a multiple of the chunk: -1e30 logi
            (23, 8, True),     # padding; and a carried state
            (40, 16, True),
            (12, 256, False)):
        case = f"s {s} chunk {chunk} carry {carry}"
        x = _x((2, s, cfg.d_model), 5)
        state = None
        if carry:   # a state left by a first stretch of input
            _, state = jr.mlstm_parallel(ref, cfg,
                                         jnp.asarray(_x((2, 9, 64), 6)),
                                         chunk=chunk)
        want, want_st = jr.mlstm_parallel(ref, cfg, jnp.asarray(x),
                                          chunk=chunk, state=state)
        got, got_st = tr.mlstm_parallel(
            port, tcfg, _t(x), chunk=chunk,
            state=None if state is None else tr.MLSTMState(*map(_t, state)))
        np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL,
                                   err_msg=case)
        _close_states(got_st, want_st)


def test_slstm_matches(mixers):
    cfg, tcfg, ref, port = mixers["slstm"]
    for carry in (False, True):
        x = _x((2, 12, cfg.d_model), 8)
        state = None
        if carry:
            _, state = jr.slstm(ref, cfg, jnp.asarray(_x((2, 5, 64), 9)))
        want, want_st = jr.slstm(ref, cfg, jnp.asarray(x), state)
        got, got_st = tr.slstm(
            port, tcfg, _t(x),
            None if state is None else tr.SLSTMState(*map(_t, state)))
        np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL,
                                   err_msg=f"carry {carry}")
        _close_states(got_st, want_st)


def test_rglru_matches(mixers):
    cfg, tcfg, ref, port = mixers["rglru"]
    rglru = jax.jit(lambda p, x, st: jr.rglru(p, cfg, x, st))
    for s, carry in ((17, False), (17, True), (1, False), (64, True)):
        x = _x((2, s, cfg.d_model), 10)
        state = None
        if carry:
            _, state = rglru(ref, jnp.asarray(_x((2, 6, 64), 11)), None)
        want, want_st = rglru(ref, jnp.asarray(x), state)
        got, got_st = tr.rglru(
            port, tcfg, _t(x),
            None if state is None else tr.RGLRUState(*map(_t, state)))
        np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL,
                                   err_msg=f"s {s} carry {carry}")
        _close_states(got_st, want_st)


def test_mixer_decode_matches(mixers):
    """Six one-token steps of each mixer from its initial state; the port
    writes the state it is given in place."""
    for kind in ("mlstm", "slstm", "rglru"):
        cfg, tcfg, ref, port = mixers[kind]
        state = getattr(jr, f"init_{kind}_state")(cfg, 2)
        tstate = getattr(tr, type(state).__name__)(*map(_t, state))
        step, tstep = getattr(jr, f"{kind}_decode"), \
            getattr(tr, f"{kind}_decode")
        rng = np.random.default_rng(7)
        for i in range(6):
            x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
            want, state = step(ref, cfg, jnp.asarray(x), state)
            got, tstate2 = tstep(port, tcfg, _t(x), tstate)
            assert tstate2 is tstate            # written in place
            np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL,
                                       err_msg=f"{kind} step {i}")
        _close_states(tstate, state)


def test_linear_scan_matches_the_loop():
    """The log-step scan against the recurrence h_t = a_t h_{t-1} + bx_t run
    step by step (fp32; the products are grouped differently)."""
    for s in (1, 2, 3, 17, 64, 100):
        rng = np.random.default_rng(s)
        a = _t(rng.uniform(0.5, 1.0, size=(2, s, 8)).astype(np.float32))
        bx = _t(rng.normal(size=(2, s, 8)).astype(np.float32))
        h = _t(rng.normal(size=(2, 8)).astype(np.float32))
        got = tr._linear_scan(a, bx, h)
        for t in range(s):
            h = a[:, t] * h + bx[:, t]
            torch.testing.assert_close(got[:, t], h, atol=1e-6, rtol=1e-6)


def _assert_logits_close(got, want, dtype, msg=""):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=msg)
        return
    assert np.abs(got - want).max() <= BF16_MAX, msg
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= BF16_ARGMAX, (msg, agree)


def test_forward_logits_match(models):
    for arch, params, tparams in models:
        for dtype in ("float32", "bfloat16"):
            cfg, tcfg = _cfgs(arch, compute_dtype=dtype)
            tok = _tokens((2, 40), cfg.vocab_size, 12)
            want, want_aux = jax.jit(lambda p, t: jm.forward(p, cfg, t))(
                params, jnp.asarray(tok))
            got, got_aux = tm.forward(tparams, tcfg, torch.from_numpy(tok))
            assert got.shape == (2, 40, cfg.padded_vocab)
            _assert_logits_close(got, want, dtype, f"{arch} {dtype}")
            assert float(got_aux) == float(want_aux) == 0.0


def test_decode_steps_match(models):
    for arch, params, tparams in models:
        for dtype in ("float32", "bfloat16"):
            cfg, tcfg = _cfgs(arch, compute_dtype=dtype)
            state = jm.init_decode_state(cfg, 3, max_len=16)
            tstate = decode_state_from_jax(state, device="cpu")
            step = jax.jit(lambda p, st, t: jm.decode_step(p, cfg, st, t))
            tok = _tokens((3, 10), cfg.vocab_size, 13)
            wants, gots = [], []
            for i in range(10):
                want, state = step(params, state, jnp.asarray(tok[:, i:i + 1]))
                got, tstate = tm.decode_step(tparams, tcfg, tstate,
                                             torch.from_numpy(tok[:, i:i + 1]))
                wants.append(_np(want))
                gots.append(_np(got))
            _assert_logits_close(np.stack(gots), np.stack(wants), dtype,
                                 f"{arch} {dtype}")
            np.testing.assert_array_equal(tstate.pos.numpy(),
                                          np.asarray(state.pos))
            if dtype == "float32":
                for got_c, want_c in zip(
                        tstate.group_caches + tstate.rem_caches,
                        state.group_caches + state.rem_caches):
                    if type(want_c).__name__.endswith("State"):
                        _close_states(got_c, want_c, atol=ATOL)


def test_port_init_matches_reference_shapes(models):
    for arch, params, _ in models:
        _, tcfg = _cfgs(arch)
        tparams, axes = tm.init_decoder(0, tcfg, device="cpu")
        assert {k: v.shape for k, v in flatten_tree(tparams).items()} == \
            {k: v.shape for k, v in flatten_tree(params).items()}, arch
        mixer = axes["groups"][0]["mixer"]
        assert mixer["wq" if arch == "xlstm-1.3b" else "w_r"].names[0] == \
            "stack"
