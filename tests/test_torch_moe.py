"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE decoders
against the JAX reference, on the CPU.

Smoke configs of ``granite-moe-1b-a400m`` and ``qwen3-moe-30b-a3b`` (4
experts, top-2); parameters from the reference's ``init_decoder`` through
``repro_torch.convert``, inputs from numpy seeds.  On the CPU the ragged
dispatch runs the expert matmuls through ``grouped_matmul``'s plain
version, in the expert-row layout the card's ``gmm`` takes (rows padded to
a multiple of 128).  Tolerances:

  * ``_route``: ``idx``, ``load`` and ``_capacity`` equal; ``gate`` and the
    aux loss within 1e-6 (fp32 softmax of the same logits).
  * ``moe_dense`` / ``moe_ragged`` in fp32: LAYER_ATOL 2e-5 against the
    reference, at capacity factors 1.25, 0.25 (drops, as
    tests/test_models.py:113) and 8 (no drops), and at a ``cap`` of 200
    (not a multiple of 128); the port's two dispatches agree within 2e-5
    where nothing is dropped (the reference's own pair test holds 1e-4).
  * ``forward`` / ``decode_step`` logits in fp32: ATOL 1e-4.
  * in bf16: at least 95% of positions have every logit within
    BF16_ATOL = 2^-5, all within 0.25, and the argmax agrees at >= 80% of
    positions.  The router selects from probabilities of a bf16 hidden
    state: where two experts' probabilities are tied to within a bf16 step,
    the two packages may pick different experts for that token (measured
    once: one position of 80, 0.12 apart), and that token's logits then
    move by more than a rounding step.  The smoke logits of random weights
    span about 0.7 over 256 entries, so the argmax flips wherever the two
    largest lie within a rounding step of each other (measured: 92-100% of
    positions agree, with every logit within 0.0075).

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
from repro.models import moe as jmoe
import repro_torch.models as tm
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import (decode_state_from_jax,
                                 decoder_params_from_jax, flatten_tree)
from repro_torch.kernels import _build
from repro_torch.models import moe as tmoe

MOE_ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
ROUTE_ATOL = 1e-6
LAYER_ATOL = 2e-5
ATOL = 1e-4
BF16_ATOL = 2.0 ** -5
BF16_MAX, BF16_SHARE, BF16_ARGMAX = 0.25, 0.95, 0.80


def _cfgs(arch, *, moe=None, **kw):
    """(reference cfg, port cfg) of the smoke ``arch`` with ``kw`` and the
    MoE fields ``moe`` replaced."""
    out = []
    for archs, smoke in ((REF_ARCHS, ref_smoke), (ARCHS, smoke_config)):
        cfg = smoke(archs[arch])
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **(moe or {})), **kw)
        out.append(cfg)
    return tuple(out)


@pytest.fixture(scope="module")
def models():
    """[(arch, reference params, port params)] for both MoE archs."""
    out = []
    for arch in MOE_ARCHS:
        cfg, _ = _cfgs(arch)
        params, _ = jm.init_decoder(jax.random.key(0), cfg)
        out.append((arch, params, decoder_params_from_jax(
            jax.tree.map(np.asarray, params), device="cpu")))
    return out


def _ffn(params, tparams):
    """Group 0, layer 0's FFN sub-tree of both parameter trees."""
    ref = jax.tree.map(lambda a: a[0], params["groups"][0]["ffn"])
    return ref, {k: v[0] for k, v in tparams["groups"][0]["ffn"].items()}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _assert_logits_close(got, want, dtype, msg=""):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=msg)
        return
    diff = np.abs(got - want).max(-1)
    assert diff.max() <= BF16_MAX, (msg, diff.max())
    assert (diff <= BF16_ATOL).mean() >= BF16_SHARE, (msg, diff)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= BF16_ARGMAX, (msg, agree)


def test_route_matches(models):
    for arch, params, tparams in models:
        cfg, tcfg = _cfgs(arch, compute_dtype="float32")
        ref_p, port_p = _ffn(params, tparams)
        x = _x((2, 40, cfg.d_model), 0)
        idx, gate, aux, load = jmoe._route(ref_p, cfg, jnp.asarray(x))
        tidx, tgate, taux, tload = tmoe._route(port_p, tcfg,
                                               torch.from_numpy(x))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx), arch)
        np.testing.assert_array_equal(tload.numpy(), np.asarray(load), arch)
        np.testing.assert_allclose(tgate.numpy(), np.asarray(gate),
                                   atol=ROUTE_ATOL, err_msg=arch)
        assert abs(float(taux) - float(aux)) <= ROUTE_ATOL, arch


def test_capacity_matches():
    """Equal for the smoke configs and the full ones (128 / 32 experts)."""
    for arch in MOE_ARCHS:
        for factor in (0.25, 1.25, 8.0):
            cfg, tcfg = _cfgs(arch, moe={"capacity_factor": factor})
            full = [dataclasses.replace(a[arch], moe=dataclasses.replace(
                a[arch].moe, capacity_factor=factor))
                for a in (REF_ARCHS, ARCHS)]
            for tokens in (1, 7, 40, 320, 4096):
                case = (arch, factor, tokens)
                assert tmoe._capacity(tcfg, tokens) == \
                    jmoe._capacity(cfg, tokens), case
                assert tmoe._capacity(full[1], tokens) == \
                    jmoe._capacity(full[0], tokens), case


def test_moe_matches_reference(models):
    """Both dispatches at capacity factors 1.25, 0.25 (drops) and 8 (no
    drops), and at 320 tokens a group: cap 200, not a multiple of the
    128-row tile."""
    for arch, params, tparams in models:
        ref_p, port_p = _ffn(params, tparams)
        for dispatch in ("dense", "ragged"):
            for factor, shape in ((1.25, (2, 40)), (0.25, (2, 64)),
                                  (8.0, (2, 16)), (1.25, (2, 320))):
                case = (arch, dispatch, factor, shape)
                cfg, tcfg = _cfgs(arch, compute_dtype="float32", moe={
                    "capacity_factor": factor, "dispatch": dispatch})
                x = _x(shape + (cfg.d_model,), 1)
                y, aux, load = jax.jit(lambda p, x: jmoe.moe(p, cfg, x))(
                    ref_p, jnp.asarray(x))
                ty, taux, tload = tmoe.moe(port_p, tcfg, torch.from_numpy(x))
                assert ty.shape == x.shape and ty.dtype == torch.float32
                np.testing.assert_allclose(ty.numpy(), np.asarray(y),
                                           atol=LAYER_ATOL, err_msg=str(case))
                np.testing.assert_array_equal(tload.numpy(), np.asarray(load),
                                              str(case))
                assert abs(float(taux) - float(aux)) <= ROUTE_ATOL, case


def test_capacity_drops_change_the_ragged_output(models):
    """At capacity factor 0.25 the ragged dispatch drops slots (its output
    leaves the dense one), at 8 it drops none (equal within LAYER_ATOL)."""
    for arch, params, tparams in models:
        _, port_p = _ffn(params, tparams)
        x = torch.from_numpy(_x((2, 64, 64), 2))
        gaps = {}
        for factor in (0.25, 8.0):
            _, tcfg = _cfgs(arch, compute_dtype="float32",
                            moe={"capacity_factor": factor})
            yd, auxd, loadd = tmoe.moe_dense(port_p, tcfg, x, expert_chunk=2)
            yr, auxr, loadr = tmoe.moe_ragged(port_p, tcfg, x)
            assert torch.equal(loadd, loadr) and float(auxd) == float(auxr)
            gaps[factor] = float((yd - yr).abs().max())
        assert gaps[8.0] <= LAYER_ATOL < gaps[0.25], (arch, gaps)


def test_ragged_takes_the_grouped_matmul_once_per_projection(models,
                                                             monkeypatch):
    """Three ``grouped_matmul`` calls (wi, wg, wo), each over every group in
    the expert-row layout; the CPU tensors never reach a launch."""
    calls = []
    real = tmoe.grouped_matmul

    def spy(xe, w, **kw):
        calls.append((tuple(xe.shape), tuple(w.shape), kw))
        return real(xe, w, **kw)

    def refuse(self, *args):
        raise AssertionError("a CPU tensor reached a CUDA launch")

    monkeypatch.setattr(tmoe, "grouped_matmul", spy)
    monkeypatch.setattr(_build.Kernel, "launch", refuse)
    for arch, params, tparams in models:
        _, tcfg = _cfgs(arch, compute_dtype="float32",
                        moe={"dispatch": "ragged"})
        _, port_p = _ffn(params, tparams)
        calls.clear()
        x = torch.from_numpy(_x((4, 40, 64), 3))   # 2 groups (moe_groups 2)
        tmoe.moe(port_p, tcfg, x)
        e = tcfg.moe
        cap = tmoe._capacity(tcfg, 2 * 40)
        rows = -(-2 * cap // 128) * 128
        assert [c[0] for c in calls] == [(e.num_experts, rows, 64)] * 2 + [
            (e.num_experts, rows, e.d_ff)], arch
        assert all(c[2]["block_rows"] == 128 for c in calls)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_forward_logits_match(models, dtype):
    for arch, params, tparams in models:
        for dispatch in ("dense", "ragged"):
            case = f"{arch} {dispatch}"
            cfg, tcfg = _cfgs(arch, compute_dtype=dtype,
                              moe={"dispatch": dispatch})
            tok = _tokens((2, 40), cfg.vocab_size, 4)
            want, want_aux = jax.jit(lambda p, t: jm.forward(p, cfg, t))(
                params, jnp.asarray(tok))
            got, got_aux = tm.forward(tparams, tcfg, torch.from_numpy(tok))
            assert got.shape == (2, 40, cfg.padded_vocab)
            _assert_logits_close(got, want, dtype, case)
            if dtype == "float32":
                assert abs(float(got_aux) - float(want_aux)) <= ROUTE_ATOL, \
                    case


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_decode_steps_match(models, dtype):
    for arch, params, tparams in models:
        for dispatch in ("dense", "ragged"):
            cfg, tcfg = _cfgs(arch, compute_dtype=dtype,
                              moe={"dispatch": dispatch})
            state = jm.init_decode_state(cfg, 3, max_len=16)
            tstate = decode_state_from_jax(state, device="cpu")
            tok = _tokens((3, 8), cfg.vocab_size, 5)
            step = jax.jit(lambda p, st, t: jm.decode_step(p, cfg, st, t))
            wants, gots = [], []
            for i in range(8):
                want, state = step(params, state, jnp.asarray(tok[:, i:i + 1]))
                got, tstate = tm.decode_step(tparams, tcfg, tstate,
                                             torch.from_numpy(tok[:, i:i + 1]))
                wants.append(_np(want))
                gots.append(_np(got))
            # the bf16 shares are taken over all 24 (step, lane) positions
            _assert_logits_close(np.stack(gots), np.stack(wants), dtype,
                                 f"{arch} {dispatch}")
            np.testing.assert_array_equal(tstate.pos.numpy(),
                                          np.asarray(state.pos))


def test_port_init_matches_reference_shapes(models):
    for arch, params, _ in models:
        _, tcfg = _cfgs(arch)
        tparams, axes = tm.init_decoder(0, tcfg, device="cpu")
        assert {k: v.shape for k, v in flatten_tree(tparams).items()} == \
            {k: v.shape for k, v in flatten_tree(params).items()}, arch
        ffn = axes["groups"][0]["ffn"]
        assert ffn["wi"].names == ("stack", "experts", "embed", "expert_mlp")
        assert float(tparams["groups"][0]["ffn"]["router_bias"].abs().max()) \
            == 0
        w = tparams["groups"][0]["ffn"]["wi"]
        assert float(w.abs().max()) <= 2.0 * tcfg.d_model ** -0.5 + 1e-7
