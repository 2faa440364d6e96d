"""codeqwen1.5-7b, granite-20b, internvl2-1b and musicgen-medium at their
own head layouts against the JAX reference, on the CPU.

``smoke_config`` gives every arch 4 / 2 heads, which hides what sets these
four apart: granite-20b's MQA (48 q heads on 1 KV head), internvl2-1b's
GQA group of 7 (14 / 2 at head dim 64), the MHA of musicgen-medium (24 /
24 at head dim 64) and codeqwen1.5-7b (32 / 32 at head dim 128), and the
modality prefix that internvl2-1b and musicgen-medium put before the
tokens.  Here each arch keeps its ``num_heads``, ``num_kv_heads``,
``head_dim``, ``activation`` and ``tie_embeddings``, and is narrowed to
d_model 64, d_ff 128, vocab 256 and 2 layers, with ``prefix_len`` cut to
PREFIX and ``flash_threshold`` 16, so that S positions take the flash
branch.

Parameters come from the reference's ``init_decoder`` through
``repro_torch.convert``; tokens, labels and prefix embeddings from numpy
seeds.  Tolerances, those of ``tests/test_torch_models.py`` and
``tests/test_torch_loss.py``: logits within ATOL 1e-4 in fp32 and
BF16_ATOL 2^-5 in bf16; the loss and its parts within LOSS_ATOL 1e-5;
every gradient leaf within GRAD_RTOL 1e-4 of that leaf's largest
|reference| entry; ``_attend_flash`` within LAYER_ATOL 2e-5.

The archs are looped inside each test (fewer than 12 items per file while
the reference's order-dependent ``test_shard_as_applies_constraint`` stays
unfixed, ROADMAP.md section 3).
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
import torch

import repro.models as jm
from repro.configs import ARCHS as REF_ARCHS
from repro.models import attention as ja
import repro_torch.models as tm
from repro_torch.configs import ARCHS
from repro_torch.convert import (decode_state_from_jax,
                                 decoder_params_from_jax, flatten_tree)
from repro_torch.models import attention as ta
from repro_torch.tree import tree_leaves, tree_unflatten

ATOL = 1e-4
BF16_ATOL = 2.0 ** -5
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
LAYER_ATOL = 2e-5
NAMES = ("codeqwen1.5-7b", "granite-20b", "internvl2-1b", "musicgen-medium")
B, S, PREFIX, DECODE_STEPS = 2, 40, 8, 8


def _narrow(cfg, **kw):
    return dataclasses.replace(
        cfg, num_layers=2, d_model=64, d_ff=128, vocab_size=256,
        prefix_len=min(cfg.prefix_len, PREFIX), flash_threshold=16, **kw)


def _cfgs(arch, **kw):
    """(reference cfg, port cfg) of ``arch`` at its own heads, narrowed."""
    return _narrow(REF_ARCHS[arch], **kw), _narrow(ARCHS[arch], **kw)


def _params(cfg):
    params, _ = jm.init_decoder(jax.random.key(0), cfg)
    return params, decoder_params_from_jax(jax.tree.map(np.asarray, params),
                                           device="cpu")


def _inputs(cfg, seed=1):
    """Tokens and labels of the body (S - prefix_len positions) and the
    prefix embeddings (None without a prefix)."""
    rng = np.random.default_rng(seed)
    body = S - cfg.prefix_len
    tok = rng.integers(0, cfg.vocab_size, (B, body)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, body)).astype(np.int32)
    pre = (rng.normal(size=(B, cfg.prefix_len, cfg.d_model)).astype(
        np.float32) if cfg.prefix_len else None)
    return tok, lab, pre


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def test_forward_with_prefix_matches_reference(monkeypatch):
    """Logits of all S positions (the prefix's too) through the flash
    branch, in fp32 and bf16, against the reference's ``forward``."""
    calls = []
    flash = ta._attend_flash
    monkeypatch.setattr(ta, "_attend_flash",
                        lambda *a, **k: calls.append(a[0].shape) or
                        flash(*a, **k))
    for arch in NAMES:
        for dtype, atol in (("float32", ATOL), ("bfloat16", BF16_ATOL)):
            cfg, tcfg = _cfgs(arch, compute_dtype=dtype)
            params, tparams = _params(cfg)
            tok, _, pre = _inputs(cfg)
            want, want_aux = jm.forward(params, cfg, jnp.asarray(tok),
                                        _j(pre))
            calls.clear()
            got, got_aux = tm.forward(tparams, tcfg, _t(tok), _t(pre))
            assert calls == [(B, S, cfg.num_heads,
                              cfg.resolved_head_dim)] * 2, (arch, calls)
            assert got.shape == (B, S, cfg.padded_vocab), arch
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=atol, err_msg=f"{arch} {dtype}")
            assert float(got_aux) == float(want_aux) == 0.0


def test_loss_and_grads_with_prefix_match_reference():
    """``loss_fn`` (chunked CE over the body, the prefix positions dropped)
    and every gradient leaf, fp32, against ``jax.value_and_grad``."""
    for arch in NAMES:
        cfg, tcfg = _cfgs(arch, compute_dtype="float32", loss_chunk=8)
        params, tparams = _params(cfg)
        tok, lab, pre = _inputs(cfg)
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jm.loss_fn(p, cfg, jnp.asarray(tok), jnp.asarray(lab),
                                 _j(pre)), has_aux=True)(params)
        leaves = tree_leaves(tparams)
        for x in leaves:
            x.requires_grad_(True)
        try:
            tloss, tmetrics = tm.loss_fn(tparams, tcfg, _t(tok), _t(lab),
                                         _t(pre))
            tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True)
        finally:
            for x in leaves:
                x.requires_grad_(False)
        assert abs(float(tloss.detach()) - float(loss)) <= LOSS_ATOL, arch
        for k in ("ce", "z_loss", "aux"):
            assert abs(float(tmetrics[k]) - float(metrics[k])) <= LOSS_ATOL, \
                (arch, k)
        got = flatten_tree(tree_unflatten(tparams, [
            np.zeros(x.shape, np.float32) if g is None else g.numpy()
            for x, g in zip(leaves, tgrads)]))
        want = flatten_tree(jax.tree.map(np.asarray, grads))
        assert got.keys() == want.keys(), arch
        for key, ref in want.items():
            tol = GRAD_RTOL * max(float(np.abs(ref).max()), 1e-30)
            err = float(np.abs(got[key] - ref).max())
            assert err <= tol, (arch, key, err, tol)


def test_decode_steps_match_reference():
    """DECODE_STEPS ``decode_step``s from an empty cache (token prompts,
    no prefix, as the serving engines feed them), fp32."""
    for arch in NAMES:
        cfg, tcfg = _cfgs(arch, compute_dtype="float32")
        params, tparams = _params(cfg)
        state = jm.init_decode_state(cfg, B, max_len=16)
        tstate = decode_state_from_jax(state, device="cpu")
        tok = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32)
        for i in range(DECODE_STEPS):
            want, state = jm.decode_step(params, cfg, state,
                                         jnp.asarray(tok[:, i:i + 1]))
            got, tstate = tm.decode_step(tparams, tcfg, tstate,
                                         _t(tok[:, i:i + 1]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, err_msg=f"{arch} {i}")
        np.testing.assert_array_equal(tstate.pos.numpy(),
                                      np.asarray(state.pos))


def test_attend_flash_at_groups_48_and_7():
    """``_attend_flash`` at granite-20b's group of 48 (48 / 1, head dim
    128) and internvl2-1b's group of 7 (14 / 2, head dim 64), fp32, causal
    and windowed, blocks narrower and wider than S."""
    rng = np.random.default_rng(3)
    for arch in ("granite-20b", "internvl2-1b"):
        cfg, tcfg = _cfgs(arch, compute_dtype="float32")
        hd = cfg.resolved_head_dim
        q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
                   for n in (cfg.num_heads, cfg.num_kv_heads,
                             cfg.num_kv_heads))
        for window, block in ((0, 16), (7, 16), (0, 1024)):
            want = ja._attend_flash(*map(jnp.asarray, (q, k, v)), cfg,
                                    window, block=block)
            got = ta._attend_flash(*map(_t, (q, k, v)), tcfg, window,
                                   block=block)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=LAYER_ATOL,
                                       err_msg=f"{arch} {window} {block}")
