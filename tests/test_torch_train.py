"""The port's training stack against the JAX reference on the CPU:
``make_train_step`` (AdamW included), ``adamw_update`` and
``lr_schedule``, ``AccumPlanner``, int8 compression with error feedback,
the ``Trainer`` with checkpoints and a failure, the prefill / serve steps
and ``python -m repro_torch.launch.train --device cpu``.

Inputs come from numpy seeds; model parameters from the reference's
``init_decoder`` through ``repro_torch.convert`` (the optimizer state
through ``adamw_state_from_jax``).  Tolerances, fp32 throughout (the two
frameworks sum in another order, nothing else):
  * loss, grad norm: LOSS_ATOL = 1e-5;  lr: rtol 1e-6 (XLA's and
    PyTorch's cos differ by an ulp);
  * first and second moments: MOMENT_RTOL = 1e-4 of each leaf's largest
    |reference| entry (the gradients' tolerance in test_torch_loss.py);
  * updated parameters: at least 99.9% of each leaf's entries within
    PARAM_ATOL = 1e-6, all within PARAM_MAX = lr / 40.  AdamW's first step
    moves an entry by lr * (g / (|g| + eps) + wd p): a sign where
    |g| >> eps = 1e-8, the same in both.  Where |g| is near eps (measured:
    at most 0.07% of a leaf's entries, |g| ~ 1e-9) the step turns on the
    gradient's absolute error, some 1e-4 of the leaf's largest entry over
    eps: measured up to 1.6e-4 at lr 1e-2;
  * the Trainer's loss history: HISTORY_ATOL = 1e-4 over 12 steps;
  * AccumPlanner weights and shares, int8 blocks, scales and residuals:
    exact.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

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
from repro.balance.accum import AccumPlanner as RefPlanner
from repro.configs import ARCHS as REF_ARCHS, smoke_config as ref_smoke
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.optim import adamw as jadam
from repro.optim import compression as jcomp
from repro.train import steps as jsteps
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.balance.accum import AccumPlanner
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import (adamw_state_from_jax,
                                 decode_state_from_jax,
                                 decoder_params_from_jax, flatten_tree)
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import init_decode_state
from repro_torch.optim import adamw as tadam
from repro_torch.optim import compression as tcomp
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves, tree_unflatten

LOSS_ATOL = 1e-5
MOMENT_RTOL = 1e-4
PARAM_ATOL = 1e-6
PARAM_SHARE = 0.999
HISTORY_ATOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
PARAM_MAX = OPT["learning_rate"] / 40


def _cfgs(arch="qwen3-4b", **kw):
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(ref_smoke(REF_ARCHS[arch]), **kw),
            dataclasses.replace(smoke_config(ARCHS[arch]), **kw))


def _flat(tree):
    """A tree of JAX arrays or of tensors -> {"a/b/0": numpy array}."""
    leaves = tree_leaves(tree)
    if any(torch.is_tensor(x) for x in leaves):
        return flatten_tree(tree_unflatten(
            tree, [x.detach().numpy() for x in leaves]))
    return flatten_tree(jax.tree.map(np.asarray, tree))


def _assert_tree_close(got, want, *, rtol, what=""):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    for key, ref in want.items():
        tol = rtol * max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got[key] - ref).max())
        assert err <= tol, (what, key, err, tol)


def _batch(cfg, b=4, s=32, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("mb,schedule", [(1, None), (2, None), (1, "ss,1")])
def test_train_step_matches_reference(mb, schedule):
    """One step: loss, grad norm, lr, the moments and the updated
    parameters; the port updates its trees in place."""
    rcfg, pcfg = _cfgs()
    params, _ = jm.init_decoder(jax.random.key(0), rcfg)
    opt = jadam.adamw_init(params)
    tparams = decoder_params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    topt = adamw_state_from_jax(jax.tree.map(np.asarray, opt), device="cpu")
    batch = _batch(rcfg)
    ocfg = jadam.OptimizerConfig(**OPT)
    new_p, new_o, m = jsteps.make_train_step(
        rcfg, ocfg, num_microbatches=mb, schedule=schedule)(
        params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    tp, to, tmet = tsteps.make_train_step(
        pcfg, tadam.OptimizerConfig(**OPT), num_microbatches=mb,
        schedule=schedule)(tparams, topt,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tp is tparams and to.mu is topt.mu
    assert int(to.step) == int(new_o.step) == 1
    assert abs(float(tmet["loss"]) - float(m["loss"])) <= LOSS_ATOL
    assert abs(float(tmet["grad_norm"]) - float(m["grad_norm"])) <= LOSS_ATOL
    np.testing.assert_allclose(float(tmet["lr"]), float(m["lr"]), rtol=1e-6)
    _assert_tree_close(to.mu, new_o.mu, rtol=MOMENT_RTOL, what="mu")
    _assert_tree_close(to.nu, new_o.nu, rtol=2 * MOMENT_RTOL, what="nu")
    got, want = _flat(tp), _flat(new_p)
    for key, ref in want.items():
        diff = np.abs(got[key] - ref)
        assert float(diff.max()) <= PARAM_MAX, (key, float(diff.max()))
        assert float((diff <= PARAM_ATOL).mean()) >= PARAM_SHARE, key


def test_adamw_update_and_schedule_match_reference():
    """Clipping active (global norm > grad_clip), three steps on a random
    tree; lr over the schedule."""
    rng = np.random.default_rng(0)

    def normal(*shape):
        return np.asarray(rng.normal(size=shape), np.float32)

    params = {"a": normal(16, 8), "b": (normal(5), normal(3, 3)),
              "c": normal()}
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6)
    jp = jax.tree.map(jnp.asarray, params)
    jo = jadam.adamw_init(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    to = tadam.adamw_init(tp)
    for step in range(3):
        grads = jax.tree.map(lambda a: normal(*a.shape) * 3, params)
        jp, jo, jm_ = jadam.adamw_update(jadam.OptimizerConfig(**cfg),
                                         jax.tree.map(jnp.asarray, grads),
                                         jo, jp)
        tp, to, tm_ = tadam.adamw_update(
            tadam.OptimizerConfig(**cfg),
            jax.tree.map(torch.as_tensor, grads), to, tp)
        assert float(jm_["grad_norm"]) > 1.0
        np.testing.assert_allclose(float(tm_["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-6)
        for name, a, b in (("p", tp, jp), ("mu", to.mu, jo.mu),
                           ("nu", to.nu, jo.nu)):
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=f"{name} step {step}")
    ocfg = dict(learning_rate=3e-4, warmup_steps=100, total_steps=10_000)
    for s in (0, 1, 5, 99, 100, 101, 2500, 9999, 10_000, 20_000):
        want = float(jadam.lr_schedule(jadam.OptimizerConfig(**ocfg),
                                       jnp.asarray(s, jnp.int32)))
        got = float(tadam.lr_schedule(tadam.OptimizerConfig(**ocfg),
                                      torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    axes = tadam.adamw_state_axes({"w": "ax"})
    assert axes.mu == axes.nu == {"w": "ax"}


def test_accum_planner_matches_reference():
    """Weights after every update and shares, over drifting step times,
    for awf and awf_b with adapt every 1 and 3 steps; exact."""
    rng = np.random.default_rng(0)
    for sched, workers, batch in (("awf", 4, 64), ("awf_b,1,adapt=3", 3, 10),
                                  ("awf", 8, 8)):
        a = AccumPlanner(num_workers=workers, global_batch=batch,
                         schedule=sched)
        b = RefPlanner(num_workers=workers, global_batch=batch,
                       schedule=sched)
        speed = rng.uniform(0.7, 1.6, workers)
        for _ in range(12):
            t = speed * rng.uniform(0.9, 1.1, workers)
            np.testing.assert_array_equal(a.update(t), b.update(t))
            np.testing.assert_array_equal(a.shares(), b.shares())
            assert int(a.shares().sum()) == batch
    with pytest.raises(ValueError, match="AWF"):
        AccumPlanner(num_workers=2, global_batch=4, schedule="gss")


def test_int8_compression_and_error_feedback_match_reference():
    """quantize_int8 / dequantize_int8 on sizes below, at and above a block
    and an error-feedback round trip over three steps; exact."""
    rng = np.random.default_rng(0)
    for shape in ((7,), (2048,), (3, 1500), (2, 3, 4, 100)):
        x = (rng.normal(size=shape) * 10 ** rng.uniform(-3, 3)).astype(
            np.float32)
        q, s = tcomp.quantize_int8(torch.from_numpy(x))
        rq, rs = jcomp.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(
            tcomp.dequantize_int8(q, s, shape).numpy(),
            np.asarray(jcomp.dequantize_int8(rq, rs, shape)))
    grads = {"w": (3, 1500), "b": (17,)}
    ef = tcomp.ef_init({k: torch.zeros(v) for k, v in grads.items()})
    ref = jcomp.ef_init({k: jnp.zeros(v) for k, v in grads.items()})
    for _ in range(3):
        g = {k: rng.normal(size=v).astype(np.float32)
             for k, v in grads.items()}
        deq, ef = tcomp.ef_compress_decompress(
            {k: torch.from_numpy(v) for k, v in g.items()}, ef)
        rdeq, ref = jcomp.ef_compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, ref)
        for k in grads:
            np.testing.assert_array_equal(deq[k].numpy(), np.asarray(rdeq[k]))
            np.testing.assert_array_equal(ef.residual[k].numpy(),
                                          np.asarray(ref.residual[k]))


def test_trainer_with_a_failure_matches_reference(tmp_path):
    """12 steps, a checkpoint every 4, a RuntimeError at step 6 once: both
    trainers restore step 4 and replay.  Started from the same state, the
    loss histories agree; the port's replayed steps 4 and 5 repeat the first
    pass's losses bit for bit."""
    rcfg, pcfg = _cfgs()
    ocfg = dict(learning_rate=3e-3, warmup_steps=2, total_steps=12)
    dkw = dict(vocab_size=rcfg.vocab_size, seq_len=32, global_batch=4,
               mean_doc_len=38.4)
    tkw = dict(steps=12, checkpoint_every=4, log_every=100)

    def hook():
        fired = []

        def fail(step):
            if step == 6 and not fired:
                fired.append(step)
                raise RuntimeError("injected failure")
        return fail

    ref = RefTrainer(rcfg, jadam.OptimizerConfig(**ocfg),
                     RefTrainerConfig(checkpoint_dir=str(tmp_path / "ref"),
                                      **tkw),
                     RefDataConfig(**dkw), failure_hook=hook())
    params, opt = ref.init_state(0)
    params, opt = jax.tree.map(np.asarray, (params, opt))
    port = Trainer(pcfg, tadam.OptimizerConfig(**ocfg),
                   TrainerConfig(checkpoint_dir=str(tmp_path / "port"),
                                 **tkw),
                   DataConfig(**dkw), failure_hook=hook(), device="cpu")
    port.init_state = lambda seed=0: (
        decoder_params_from_jax(params, device="cpu"),
        adamw_state_from_jax(opt, device="cpu"))
    want = ref.run()
    got = port.run()
    steps = [r["step"] for r in got]
    assert steps == [r["step"] for r in want] == [*range(6), *range(4, 12)]
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) <= HISTORY_ATOL, (a, b)
        assert a["tokens"] == b["tokens"] and a["shares"] == b["shares"]
        assert a["padding"] == b["padding"]
    assert [got[i]["loss"] for i in (4, 5)] == [got[i]["loss"]
                                               for i in (6, 7)]
    assert port.store.steps() == ref.store.steps() == [4, 8, 12]


def test_prefill_and_greedy_serve_steps_match_reference():
    """Last-position prefill logits within 1e-4; three greedy decode steps
    give the reference's tokens (the sampled step: test_torch_random.py)."""
    rcfg, pcfg = _cfgs()
    params, _ = jm.init_decoder(jax.random.key(0), rcfg)
    tparams = decoder_params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    tokens = _batch(rcfg, b=2, s=12)["tokens"]
    want = jsteps.make_prefill_step(rcfg)(params,
                                          {"tokens": jnp.asarray(tokens)})
    got = tsteps.make_prefill_step(pcfg)(tparams,
                                         {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    rstate = jm.init_decode_state(rcfg, 2, 16)
    state = decode_state_from_jax(jax.tree.map(np.asarray, rstate),
                                  device="cpu")
    rstep = jsteps.make_serve_step(rcfg)
    step = tsteps.make_serve_step(pcfg)
    rtok, tok = jnp.asarray(tokens[:, :1]), torch.from_numpy(tokens[:, :1])
    for _ in range(3):
        rtok, rstate = rstep(params, rstate, rtok, jax.random.key(0))
        tok, state = step(tparams, state, tok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
    assert init_decode_state(pcfg, 2, 16, device="cpu").pos.shape == (2,)


def test_launch_train_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` at 3 steps prints
    the reference's lines and leaves its final checkpoint."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ckpt = tmp_path / "run"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-4b", "--steps", "3", "--batch", "2", "--seq", "32",
         "--ckpt", str(ckpt), "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, check=True
    ).stdout.splitlines()
    cfg = ref_smoke(REF_ARCHS["qwen3-4b"])
    assert out[0] == (f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
                      f"family={cfg.family}")
    assert out[1].startswith("step 0 loss=")
    assert out[-1].startswith("loss first3=") and \
        out[-1].endswith("checkpoints=[3]")
    assert (tmp_path / "run_qwen3-4b" / "step_00000003" /
            "manifest.json").is_file()
