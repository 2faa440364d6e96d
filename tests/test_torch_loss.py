"""The port's ``loss_fn`` and its gradients against the JAX reference's
``jax.value_and_grad(loss_fn)``, on the CPU, for all 10 architectures at
``smoke_config`` in fp32 compute.

Parameters come from the reference's ``init_decoder`` through
``repro_torch.convert``; tokens, labels and prefix embeddings from numpy
seeds.  Tolerances (fp32; the two frameworks sum in another order, nothing
else): the loss and its parts within LOSS_ATOL = 1e-5 (a loss near 5.5,
some 40 fp32 ulps); every gradient leaf within GRAD_RTOL = 1e-4 of that
leaf's largest |reference| entry (measured: 2e-6 for the attention and MoE
models, 1.8e-5 for the recurrent ones, whose scans sum over time).

``flash_dense``'s plain backward (``flash_attention_dense_bwd_plain``,
the version ``csrc/flash_dense_bwd.cu`` is held to on the card) and the
CPU path of ``flash_attention_dense_bshd`` under autograd are held to
``jax.vjp`` of the reference's ``_attend_flash`` within FLASH_GRAD_ATOL =
2e-5 (fp32 inputs, gradients of magnitude ~1).

The cases share items (fewer than 12 per file while the reference's
order-dependent ``test_shard_as_applies_constraint`` stays unfixed,
ROADMAP.md section 3).
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
import repro_torch.models as tm
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import decoder_params_from_jax, flatten_tree
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.models import attention as ta
from repro_torch.models import decoder as tdec
from repro_torch.tree import tree_leaves, tree_unflatten

LOSS_ATOL = 1e-5
FLASH_GRAD_ATOL = 2e-5
GRAD_RTOL = 1e-4
B, S = 2, 32


def _cfgs(arch, **kw):
    kw = dict(compute_dtype="float32", **kw)
    if "dispatch" in kw:
        dispatch = kw.pop("dispatch")
        kw["moe"] = dataclasses.replace(ref_smoke(REF_ARCHS[arch]).moe,
                                        dispatch=dispatch)
    return (dataclasses.replace(ref_smoke(REF_ARCHS[arch]), **kw),
            dataclasses.replace(smoke_config(ARCHS[arch]), **kw))


def _inputs(cfg, s=S, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    pre = (rng.normal(size=(B, cfg.prefix_len, cfg.d_model)).astype(
        np.float32) if cfg.prefix_len else None)
    return tok, lab, pre


def port_value_and_grad(tparams, cfg, tok, lab, pre):
    """(loss, metrics, grads as a tree like ``tparams``)."""
    leaves = tree_leaves(tparams)
    for x in leaves:
        x.requires_grad_(True)
    try:
        loss, metrics = tm.loss_fn(
            tparams, cfg, torch.from_numpy(tok), torch.from_numpy(lab),
            None if pre is None else torch.from_numpy(pre))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(tparams, grads))


def _check(arch, s=S, **kw):
    rcfg, pcfg = _cfgs(arch, **kw)
    params, _ = jm.init_decoder(jax.random.key(0), rcfg)
    tparams = decoder_params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    tok, lab, pre = _inputs(rcfg, s)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, rcfg, jnp.asarray(tok), jnp.asarray(lab),
                             None if pre is None else jnp.asarray(pre)),
        has_aux=True)(params)
    tloss, tmetrics, tgrads = port_value_and_grad(tparams, pcfg, tok, lab,
                                                  pre)
    assert abs(float(tloss) - float(loss)) <= LOSS_ATOL, (arch, kw)
    for k in ("ce", "z_loss", "aux"):
        assert abs(float(tmetrics[k]) - float(metrics[k])) <= LOSS_ATOL, k
    want = flatten_tree(jax.tree.map(np.asarray, grads))
    got = flatten_tree(tree_unflatten(
        tgrads, [g.numpy() for g in tree_leaves(tgrads)]))
    assert got.keys() == want.keys()
    for key, ref in want.items():
        tol = GRAD_RTOL * max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got[key] - ref).max())
        assert err <= tol, (arch, kw, key, err, tol)


@pytest.mark.parametrize("archs", [
    ("qwen3-4b", "stablelm-3b", "codeqwen1.5-7b", "granite-20b"),
    ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b"),
    ("xlstm-1.3b", "recurrentgemma-2b"),
    ("internvl2-1b", "musicgen-medium"),
], ids=["dense", "moe", "recurrent", "prefix"])
def test_loss_and_grads_match_reference(archs):
    """Every arch, the chunked CE path (loss_chunk 8 over 32 positions):
    the loss, its ce / z_loss / aux parts and every gradient leaf."""
    for arch in archs:
        _check(arch, loss_chunk=8)


def test_flash_window_and_ragged_moe_grads_match_reference(monkeypatch):
    """Above a lowered flash_threshold: qwen3-4b's flash branch under
    remat "full", recurrentgemma-2b's windowed flash branch (window 32
    inside 48 positions) under remat "dots" with the loss unchunked; and
    the ragged MoE dispatch of qwen3-moe-30b-a3b."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[4])
        return flash(*args, **kwargs)

    flash = ta._attend_flash
    monkeypatch.setattr(ta, "_attend_flash", spy)
    _check("qwen3-4b", flash_threshold=16, loss_chunk=8, remat="full")
    assert calls and set(calls) == {0}
    calls.clear()
    _check("recurrentgemma-2b", s=48, flash_threshold=16, loss_chunk=0,
           remat="dots")
    assert calls and set(calls) == {32}
    _check("qwen3-moe-30b-a3b", dispatch="ragged", loss_chunk=8)


def test_remat_policies_agree(monkeypatch):
    """none, dots and full give the same loss and gradients (the
    recomputation repeats the same fp32 ops on the CPU), and the chunked
    loss equals the unchunked one within LOSS_ATOL; a forward that
    autograd does not record (under ``torch.no_grad()``, or on parameters
    that do not require grad) runs no checkpoint."""
    rcfg, _ = _cfgs("qwen3-4b")
    params, _ = jm.init_decoder(jax.random.key(0), rcfg)
    tok, lab, pre = _inputs(rcfg)
    out = {}
    for remat in ("none", "dots", "full"):
        _, pcfg = _cfgs("qwen3-4b", remat=remat, loss_chunk=8)
        tparams = decoder_params_from_jax(jax.tree.map(np.asarray, params),
                                          device="cpu")
        out[remat] = port_value_and_grad(tparams, pcfg, tok, lab, pre)
    base = out["none"]
    for remat in ("dots", "full"):
        loss, _, grads = out[remat]
        assert torch.equal(loss, base[0]), remat
        for a, b in zip(tree_leaves(grads), tree_leaves(base[2])):
            assert torch.equal(a, b), remat
    _, pcfg = _cfgs("qwen3-4b", loss_chunk=0)
    tparams = decoder_params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    whole, _, _ = port_value_and_grad(tparams, pcfg, tok, lab, pre)
    assert abs(float(whole) - float(base[0])) <= LOSS_ATOL
    seen = []
    real = tdec.checkpoint
    monkeypatch.setattr(tdec, "checkpoint",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    _, pcfg = _cfgs("qwen3-4b", remat="full")
    tm.forward(tparams, pcfg, torch.from_numpy(tok))
    with torch.no_grad():
        for x in tree_leaves(tparams):
            x.requires_grad_(True)
        tm.forward(tparams, pcfg, torch.from_numpy(tok))
        for x in tree_leaves(tparams):
            x.requires_grad_(False)
    assert not seen
    port_value_and_grad(tparams, pcfg, tok, lab, pre)
    assert seen


def test_flash_plain_backward_matches_reference_autodiff():
    """dq, dk, dv of the dense function (GQA, MQA, causal, windows
    narrower and wider than the sequence, head dims of 40 and 256) against
    ``jax.vjp`` of the reference's ``_attend_flash``."""
    rng = np.random.default_rng(0)
    for b, s, h, kvh, hd, window in ((2, 40, 4, 2, 16, 0),
                                     (1, 33, 4, 1, 8, 7),
                                     (2, 24, 2, 2, 16, 100),
                                     # a head dim the card pads (to 64)
                                     (1, 20, 2, 1, 40, 9),
                                     # recurrentgemma-2b's geometry: MQA
                                     # 10 / 1 at head dim 256, a window
                                     # narrower than s
                                     (1, 48, 10, 1, 256, 16)):
        q, k, v, do = (rng.normal(size=(b, s, n, hd)).astype(np.float32)
                       for n in (h, kvh, kvh, h))
        _, vjp = jax.vjp(lambda q_, k_, v_: ja._attend_flash(
            q_, k_, v_, None, window), *map(jnp.asarray, (q, k, v)))
        want = vjp(jnp.asarray(do))
        tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
        got = fa.flash_attention_dense_bwd_plain(tq, tk, tv, tdo,
                                                 window=window)
        leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
        out = fa.flash_attention_dense_bshd(*leaves, window=window)
        out.backward(tdo)
        for name, a, c, ref in zip("qkv", got, leaves, want):
            ref = np.asarray(ref)
            assert a.shape == ref.shape, name
            assert float(np.abs(a.numpy() - ref).max()) <= FLASH_GRAD_ATOL
            assert float(np.abs(c.grad.numpy() - ref).max()) \
                <= FLASH_GRAD_ATOL, name
