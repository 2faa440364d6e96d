"""``repro_torch.random`` against ``jax.random`` on the CPU, and the sampled
decoding built on it against the reference's.

Tolerances:
  * ``key``, ``split``, ``bits`` and ``uniform``: bit for bit (integer
    arithmetic, then the mantissa trick and one fused multiply-add);
  * ``gumbel``: within GUMBEL_ULPS ulp of max(|g|, 1): ``-log(-log(u))`` of
    the same ``u``, the port's logs in float64 rounded once, XLA's in
    float32, each within an ulp or two of the exact value;
  * ``categorical`` and every sampled token: equal.  The Gumbel gap can
    flip a token only where two noisy logits lie within an ulp or so; each
    test reports how many tokens it compared, so that a seed cannot hide a
    shortfall.
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
from repro.serve.engine import DecodeEngine as RefEngine
from repro.serve.scheduler import Request as RefRequest
from repro.train import steps as jsteps
from repro_torch import random as trandom
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import (decode_state_from_jax,
                                 decoder_params_from_jax, key_from_jax)
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.scheduler import Request
from repro_torch.train import steps as tsteps

SEEDS = (0, 1, 42, 2 ** 31 - 1)
SPLIT_NUMS = (2, 3, 7)
# (4, 151936): qwen3-4b's padded vocabulary for 4 lanes, an even count
# far past one counter word's low bits; the odd sizes show the layout
SHAPES = ((), (1,), (5,), (3, 7, 11), (4, 151936))
GUMBEL_ULPS = 4
CATEGORICAL_KEYS, CATEGORICAL_ROWS, CATEGORICAL_VOCAB = 8, 64, 32000


def _jkey(seed):
    return jax.random.key(seed)


def _data(jkey):
    return np.asarray(jax.random.key_data(jkey))


def test_key_split_and_bits_equal_jax():
    for seed in SEEDS:
        jk = _jkey(seed)
        k = trandom.key(seed, device="cpu")
        np.testing.assert_array_equal(k.numpy(), _data(jk))
        np.testing.assert_array_equal(
            key_from_jax(_data(jk), device="cpu").numpy(), k.numpy())
        for num in SPLIT_NUMS:
            np.testing.assert_array_equal(
                trandom.split(k, num).numpy(),
                _data(jax.random.split(jk, num)), err_msg=f"{seed} {num}")
            # the tensor form a key on the card takes: 0-d tensor words
            x0, x1 = trandom.threefry2x32(
                k[0], k[1], torch.zeros(num, dtype=torch.int64),
                torch.arange(num))
            np.testing.assert_array_equal(
                torch.stack([x0, x1], -1).numpy(),
                _data(jax.random.split(jk, num)), err_msg=f"{seed} {num}")
        for shape in SHAPES:
            got = trandom.bits(k, shape).numpy()
            want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{seed} {shape}")
    with pytest.raises(ValueError, match="uint32"):
        key_from_jax(np.zeros(2, np.int32), device="cpu")


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.7, 5.1)])
def test_uniform_equals_jax(lo, hi):
    for seed in SEEDS:
        k, jk = trandom.key(seed, device="cpu"), _jkey(seed)
        for shape in SHAPES:
            got = trandom.uniform(k, shape, torch.float32, lo, hi)
            want = np.asarray(jax.random.uniform(jk, shape, jnp.float32,
                                                 lo, hi))
            assert got.dtype == torch.float32
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{seed} {shape}")
    with pytest.raises(TypeError, match="float32"):
        trandom.uniform(trandom.key(0, device="cpu"), (2,), torch.bfloat16)


def test_gumbel_within_ulps_of_jax():
    worst = 0.0
    for seed in SEEDS:
        got = trandom.gumbel(trandom.key(seed, device="cpu"),
                             (4, 151936)).numpy()
        want = np.asarray(jax.random.gumbel(_jkey(seed), (4, 151936)))
        ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
        worst = max(worst, float((np.abs(got - want) / ulp).max()))
    print(f"gumbel: max gap {worst} ulp of max(|g|, 1)")
    assert worst <= GUMBEL_ULPS


def test_categorical_tokens_equal_jax():
    rng = np.random.default_rng(0)
    compared = equal = 0
    for seed in range(CATEGORICAL_KEYS):
        logits = (3 * rng.standard_normal(
            (CATEGORICAL_ROWS, CATEGORICAL_VOCAB))).astype(np.float32)
        got = trandom.categorical(trandom.key(seed, device="cpu"),
                                  torch.from_numpy(logits)).numpy()
        want = np.asarray(jax.random.categorical(_jkey(seed),
                                                 jnp.asarray(logits)))
        compared += want.size
        equal += int((got == want).sum())
    print(f"categorical: {equal} of {compared} tokens equal")
    assert compared == CATEGORICAL_KEYS * CATEGORICAL_ROWS
    assert equal == compared


def _models():
    kw = dict(prefix_len=0, compute_dtype="float32")
    cfg = dataclasses.replace(ref_smoke(REF_ARCHS["qwen3-4b"]), **kw)
    tcfg = dataclasses.replace(smoke_config(ARCHS["qwen3-4b"]), **kw)
    params, _ = jm.init_decoder(jax.random.key(0), cfg)
    tparams = decoder_params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    return cfg, params, tcfg, tparams


@pytest.mark.parametrize("seed,temperature", [(0, 1.0), (7, 0.7)])
def test_engine_sampled_tokens_match_reference(seed, temperature):
    cfg, params, tcfg, tparams = _models()
    outputs = []
    for engine_cls, req_cls, c, p, extra in (
            (RefEngine, RefRequest, cfg, params, {}),
            (DecodeEngine, Request, tcfg, tparams, {"device": "cpu"})):
        eng = engine_cls(c, p, slots=2, max_len=64, greedy=False,
                         temperature=temperature, seed=seed, **extra)
        for i in range(5):
            eng.submit(req_cls(rid=i, arrival=0.0, prompt_len=4 + i,
                               max_new_tokens=6 + i))
        assert eng.run().completed == 5
        outputs.append({i: eng.output(i) for i in range(5)})
    ref, port = outputs
    compared = sum(len(out) for out in ref.values())
    print(f"engine seed {seed}: {compared} sampled tokens compared")
    assert compared == sum(6 + i for i in range(5))
    assert port == ref


def test_sampled_serve_step_matches_reference():
    cfg, params, tcfg, tparams = _models()
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    rstate = jm.init_decode_state(cfg, 4, 16)
    state = decode_state_from_jax(jax.tree.map(np.asarray, rstate),
                                  device="cpu")
    rstep = jsteps.make_serve_step(cfg, sample=True, temperature=0.8)
    step = tsteps.make_serve_step(tcfg, sample=True, temperature=0.8)
    rtok, tok = jnp.asarray(tokens), torch.from_numpy(tokens)
    rkey = jax.random.key(11)
    compared = 0
    for _ in range(4):
        rkey, sub = jax.random.split(rkey)
        rtok, rstate = rstep(params, rstate, rtok, sub)
        tok, state = step(tparams, state, tok,
                          key_from_jax(_data(sub), device="cpu"))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        compared += tok.numel()
    assert compared == 16
