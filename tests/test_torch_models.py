"""The port's dense decoder (``repro_torch.models``) against the JAX
reference on ``smoke_config(qwen3-4b)``, on the CPU.

Parameters come from the reference's ``init_decoder`` through
``repro_torch.convert``; inputs from numpy seeds.  Tolerances:

  * fp32 (``compute_dtype="float32"``): ATOL 1e-4 on logits and 2e-5 on
    layer outputs; the two frameworks sum in another order, nothing else.
  * bf16 (the configs' default compute dtype): BF16_ATOL = 2^-5 on logits
    of magnitude < 1.  The residual stream is bf16 (8 significant bits,
    a step of 2^-8 to 2^-7 near 1), and XLA and PyTorch round matmul and
    elementwise results to bf16 at different points, so a logit can move
    by a few bf16 steps; measured 0.008 at most.
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
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import mlp as jmlp
import repro_torch.models as tm
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import (decode_state_from_jax,
                                 decoder_params_from_jax, flatten_tree)
from repro_torch.kernels import _build
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import mlp as tmlp

ATOL = 1e-4
LAYER_ATOL = 2e-5
BF16_ATOL = 2.0 ** -5
_ATTEND_FLASH = ta._attend_flash


def _cfgs(**kw):
    """(reference cfg, port cfg) of smoke qwen3-4b with ``kw`` replaced."""
    return (dataclasses.replace(ref_smoke(REF_ARCHS["qwen3-4b"]), **kw),
            dataclasses.replace(smoke_config(ARCHS["qwen3-4b"]), **kw))


@pytest.fixture(scope="module")
def model():
    cfg, _ = _cfgs()
    params, _ = jm.init_decoder(jax.random.key(0), cfg)
    tparams = decoder_params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    return params, tparams


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _layer(params, tparams, name="mixer"):
    """Group 0, layer 0's sub-tree of both parameter trees."""
    ref = jax.tree.map(lambda a: a[0], params["groups"][0][name])
    return ref, {k: v[0] for k, v in tparams["groups"][0][name].items()}


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = tl.rms_norm(_t(x), _t(scale), 1e-6)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


@pytest.mark.parametrize("ragged", (False, True))
def test_rope_matches(ragged):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 1 if ragged else 9, 4, 16)).astype(np.float32)
    pos = np.array([[3], [70]], np.int32) if ragged else np.arange(9)
    ws, wc = jl.rope_tables(jnp.asarray(pos), 16, 1e6)
    gs, gc = tl.rope_tables(_t(pos), 16, 1e6)
    np.testing.assert_allclose(_np(gs), _np(ws), atol=1e-5)
    np.testing.assert_allclose(_np(gc), _np(wc), atol=1e-5)
    want = jl.apply_rope(jnp.asarray(x), ws, wc)
    got = tl.apply_rope(_t(x), gs, gc)
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL)


def test_mlp_matches(model):
    cfg, tcfg = _cfgs(compute_dtype="float32")
    ref_p, port_p = _layer(*model, name="ffn")
    x = np.random.default_rng(2).normal(size=(2, 7, 64)).astype(np.float32)
    np.testing.assert_allclose(_np(tmlp.mlp(port_p, tcfg, _t(x))),
                               _np(jmlp.mlp(ref_p, cfg, jnp.asarray(x))),
                               atol=LAYER_ATOL)


def _qkv(seed, b=2, s=40, h=4, kvh=2, hd=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, n, hd)).astype(np.float32)
                 for n in (h, kvh, kvh))


@pytest.mark.parametrize("window", (0, 5))
def test_attend_full_matches(window):
    cfg, tcfg = _cfgs(compute_dtype="float32")
    q, k, v = _qkv(3)
    want = ja._attend_full(*map(jnp.asarray, (q, k, v)), cfg, window)
    got = ta._attend_full(*map(_t, (q, k, v)), tcfg, window)
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL)


@pytest.mark.parametrize("block", (16, 1024))
@pytest.mark.parametrize("window", (0, 7))
def test_attend_flash_matches(window, block):
    cfg, tcfg = _cfgs(compute_dtype="float32")
    q, k, v = _qkv(4)
    want = ja._attend_flash(*map(jnp.asarray, (q, k, v)), cfg, window,
                            block=block)
    got = ta._attend_flash(*map(_t, (q, k, v)), tcfg, window, block=block)
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL)


@pytest.mark.parametrize("branch", ("full", "flash"))
def test_attention_both_branches_match(model, branch, monkeypatch):
    # s = 40 is above a flash_threshold lowered to 16, below the default
    thr = 16 if branch == "flash" else 2048
    cfg, tcfg = _cfgs(compute_dtype="float32", flash_threshold=thr)
    ref_p, port_p = _layer(*model)
    x = np.random.default_rng(5).normal(size=(2, 40, 64)).astype(np.float32)
    sin, cos = jl.rope_tables(jnp.arange(40), 16, cfg.rope_theta)
    called = []
    monkeypatch.setattr(ta, "_attend_flash", lambda *a, **k: called.append(1)
                        or _ATTEND_FLASH(*a, **k))
    want = ja.attention(ref_p, cfg, jnp.asarray(x), sin, cos)
    got = ta.attention(port_p, tcfg, _t(x), *map(_t, (sin, cos)))
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL)
    assert bool(called) == (branch == "flash")


def _decode_both(model, cache_kind, window, steps=6):
    kv_dtype = "int8" if cache_kind == "int8" else "bfloat16"
    cfg, tcfg = _cfgs(compute_dtype="float32", kv_cache_dtype=kv_dtype)
    ref_p, port_p = _layer(*model)
    max_len = 16
    if cache_kind == "int8":
        jc = ja.init_kv_cache_q(cfg, 2, max_len, window=window)
        tc = ta.init_kv_cache_q(tcfg, 2, max_len, window=window, device="cpu")
    else:
        jc = ja.init_kv_cache(cfg, 2, max_len, window=window)
        tc = ta.init_kv_cache(tcfg, 2, max_len, window=window, device="cpu")
    rng = np.random.default_rng(6)
    for i in range(steps):
        x = rng.normal(size=(2, 1, 64)).astype(np.float32)
        pos = np.asarray(jc.pos)[:, None]
        sin, cos = jl.rope_tables(jnp.asarray(pos), 16, cfg.rope_theta)
        want, jc = ja.attention_decode(ref_p, cfg, jnp.asarray(x), sin, cos,
                                       jc, window=window)
        got, tc = ta.attention_decode(port_p, tcfg, _t(x), *map(_t, (sin, cos)),
                                      tc, window=window)
        np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL,
                                   err_msg=f"step {i}")
    return jc, tc


@pytest.mark.parametrize("cache_kind,window", [
    ("bf16", 0), ("int8", 0), ("bf16", 4), ("int8", 4)])
def test_attention_decode_matches(model, cache_kind, window):
    # window 4 on a 16-slot cache: a 4-slot ring buffer, wrapped after 6 steps
    jc, tc = _decode_both(model, cache_kind, window)
    # the cached K/V come from fp32 projections that differ in the last
    # bit, so a stored value may sit one bf16 step (rtol 2^-7) or one int8
    # step away; positions are exact
    for field in jc._fields:
        got, want = _np(getattr(tc, field)), _np(getattr(jc, field))
        if field == "pos":
            np.testing.assert_array_equal(got, want)
        elif getattr(tc, field).dtype == torch.int8:
            assert np.abs(got - want).max() <= 1, field
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0,
                                       err_msg=field)


def test_quantize_token_matches():
    x = np.random.default_rng(7).normal(size=(3, 1, 2, 16)).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]    # ties round half to even
    wq, ws = ja._quantize_token(jnp.asarray(x))
    gq, gs = ta._quantize_token(_t(x))
    assert gq.dtype == torch.int8
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("dtype,thr", [("float32", 2048), ("float32", 16),
                                       ("bfloat16", 2048), ("bfloat16", 16)])
def test_forward_logits_match(model, dtype, thr):
    params, tparams = model
    cfg, tcfg = _cfgs(compute_dtype=dtype, flash_threshold=thr)
    tok = _tokens((2, 40), cfg.vocab_size)
    want, want_aux = jm.forward(params, cfg, jnp.asarray(tok))
    got, got_aux = tm.forward(tparams, tcfg, _t(tok))
    assert got.shape == (2, 40, cfg.padded_vocab) and got.dtype == torch.float32
    atol = ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    assert float(got_aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("dtype,kv", [("float32", "bfloat16"),
                                      ("float32", "int8"),
                                      ("bfloat16", "bfloat16")])
def test_decode_steps_with_ragged_pos_match(model, dtype, kv):
    params, tparams = model
    cfg, tcfg = _cfgs(compute_dtype=dtype, kv_cache_dtype=kv)
    state = jm.init_decode_state(cfg, 3, max_len=32)
    ragged = jnp.asarray([0, 5, 11], jnp.int32)    # per-lane positions
    state = state._replace(
        pos=ragged,
        group_caches=tuple(c._replace(pos=jnp.broadcast_to(ragged, c.pos.shape))
                           for c in state.group_caches))
    tstate = decode_state_from_jax(state, device="cpu")
    tok = _tokens((3, 8), cfg.vocab_size, seed=8)
    atol = ATOL if dtype == "float32" else BF16_ATOL
    for i in range(8):
        want, state = jm.decode_step(params, cfg, state,
                                     jnp.asarray(tok[:, i:i + 1]))
        got, tstate = tm.decode_step(tparams, tcfg, tstate, _t(tok[:, i:i + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   err_msg=f"step {i}")
    np.testing.assert_array_equal(tstate.pos.numpy(), np.asarray(state.pos))
    np.testing.assert_array_equal(tstate.group_caches[0].pos.numpy(),
                                  np.asarray(state.group_caches[0].pos))


def test_forward_equals_token_by_token_decode(model):
    # the decode cache holds K and V in bf16 (the default cache dtype, as in
    # the reference) while forward keeps them fp32: BF16_ATOL
    _, tparams = model
    _, tcfg = _cfgs(compute_dtype="float32")
    tok = _tokens((2, 12), tcfg.vocab_size, seed=9)
    logits, _ = tm.forward(tparams, tcfg, _t(tok))
    state = tm.init_decode_state(tcfg, 2, max_len=16, device="cpu")
    for i in range(12):
        step, state = tm.decode_step(tparams, tcfg, state, _t(tok[:, i:i + 1]))
        np.testing.assert_allclose(step[:, 0].numpy(), logits[:, i].numpy(),
                                   atol=BF16_ATOL)


def test_port_init_decoder_shapes_match_reference(model):
    params, _ = model
    _, tcfg = _cfgs()
    tparams, axes = tm.init_decoder(0, tcfg, device="cpu")
    assert {k: v.shape for k, v in flatten_tree(tparams).items()} == \
        {k: v.shape for k, v in flatten_tree(params).items()}
    assert axes["groups"][0]["mixer"]["wq"].names == ("stack", "embed", "heads")
    w = tparams["groups"][0]["ffn"]["wi"]
    assert float(w.abs().max()) <= 2.0 * 64 ** -0.5 + 1e-7   # truncated at 2


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_decoder(0, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_decode_state(tcfg, 1, 8)


def test_cpu_flash_branch_never_reaches_a_launch(model, monkeypatch):
    def refuse(self, *args):
        raise AssertionError("a CPU tensor reached a CUDA launch")

    monkeypatch.setattr(_build.Kernel, "launch", refuse)
    _, tparams = model
    _, tcfg = _cfgs(flash_threshold=16)
    logits, _ = tm.forward(tparams, tcfg, _t(_tokens((1, 24), tcfg.vocab_size)))
    assert bool(torch.isfinite(logits).all())
