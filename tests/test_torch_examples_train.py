"""The training example twins against the originals, on the CPU.  Each
original runs its own ``main`` (checkpoints redirected into the test's tmp
dir) and its printed lines are held against the twin started from the
same state: the twin's ``Trainer.init_state`` is overridden with the
reference's ``init_decoder(key(0))`` parameters and AdamW state, carried
across with ``repro_torch.convert``, and both models compute in float32
(``compute_dtype``, patched into each side's ``ModelConfig``), as
``tests/test_torch_train.py`` does; at the examples' default bf16 the two
frameworks round differently and the losses part by ~1e-3.

Tolerance for the losses: HISTORY_ATOL = 1e-4 (``test_torch_train.py``'s
for the Trainer's history) plus 5e-5, the rounding of the printed four
decimals.  Checkpoint steps, the restart step, the final shares and the
``elastic_handoff`` loads and weights are equal.
"""

import functools
import re

import jax
import numpy as np

from torch_examples_util import load, run_main

import repro.configs.base as ref_base
import repro.models as jm
import repro.train.trainer as ref_trainer
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.convert import adamw_state_from_jax, decoder_params_from_jax

HISTORY_ATOL = 1e-4
PRINT_ROUNDING = 5e-5


def _fp32(config_cls):
    return functools.partial(config_cls, compute_dtype="float32")


def _carried(cfg):
    """``Trainer.init_state`` returning the reference's starting state."""
    params, _ = jm.init_decoder(jax.random.key(0), cfg)
    params, opt = jax.tree.map(np.asarray, (params, ref_adamw_init(params)))
    return lambda seed=0: (decoder_params_from_jax(params, device="cpu"),
                           adamw_state_from_jax(opt, device="cpu"))


def _logged_losses(lines) -> dict[int, float]:
    """Step -> loss of the ``step N loss=X`` lines (the last of a replay)."""
    out = {}
    for line in lines:
        m = re.match(r"step (\d+) loss=([0-9.]+) ", line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def _close(got: float, printed: float) -> bool:
    return abs(got - printed) <= HISTORY_ATOL + PRINT_ROUNDING


def test_train_100m_matches_reference_at_20_steps(tmp_path):
    argv = ["--steps", "20", "--batch", "2", "--seq", "64"]
    ref = load("train_100m")
    ref.ModelConfig = _fp32(ref.ModelConfig)
    want = run_main(ref, [*argv, "--ckpt", str(tmp_path / "ref")])
    mod = load("torch_train_100m")
    mod.ModelConfig = _fp32(mod.ModelConfig)
    hist, tr = mod.train(steps=20, batch=2, seq=64, ckpt=str(tmp_path / "port"),
                         device="cpu", init_state=_carried(ref.make_100m()))
    assert [h["step"] for h in hist] == list(range(20))
    logged = _logged_losses(want)
    assert sorted(logged) == [0, 10]
    for step, loss in logged.items():
        assert _close(hist[step]["loss"], loss), (step, hist[step], loss)
    first = sum(h["loss"] for h in hist[:10]) / 10
    last = sum(h["loss"] for h in hist[-10:]) / 10
    m = re.search(r"first10=([0-9.]+) -> last10=([0-9.]+)", "\n".join(want))
    assert _close(first, float(m.group(1))) and _close(last, float(m.group(2)))
    assert last < first
    assert want[-1] == f"checkpoints: {tr.store.steps()} in {tmp_path / 'ref'}"
    assert want[0] == f"model: {mod.make_100m().param_count()/1e6:.1f}M params"
    print(f"compared {len(logged) + 2} losses, the checkpoint steps and the "
          f"parameter count")


def test_elastic_restart_matches_reference(tmp_path, monkeypatch):
    """The original's checkpoints go to the tmp dir through its Trainer
    config (it imports TrainerConfig and ModelConfig inside ``main``).  The reference's
    store may restore step 8 instead of 12 after the injected failure (it
    lists the checkpoints without waiting for the pending write, a fault
    of the reference kept as it is); the replay is deterministic, so the
    last logged loss of each step is compared."""
    real = ref_trainer.TrainerConfig

    def redirected(**kw):
        kw["checkpoint_dir"] = str(tmp_path / "ref")
        return real(**kw)

    monkeypatch.setattr(ref_trainer, "TrainerConfig", redirected)
    monkeypatch.setattr(ref_base, "ModelConfig", _fp32(ref_base.ModelConfig))
    want = run_main(load("elastic_restart"))

    mod = load("torch_elastic_restart")
    mod.ModelConfig = _fp32(mod.ModelConfig)
    init = _carried(mod.config())
    ckpt = str(tmp_path / "port")
    tr1 = mod.phase1("cpu", ckpt=ckpt, init_state=init)
    assert f"phase 1 checkpoints: {tr1.store.steps()}" in want
    hist, _ = mod.phase2("cpu", ckpt=ckpt, init_state=init)
    got = "\n".join(mod.summary(hist, mod.handoff())).splitlines()
    assert got == want[-len(got):]
    losses = {h["step"]: h["loss"] for h in [*tr1.history, *hist]}
    logged = _logged_losses(want)
    assert sorted(logged) == [0, 4, 8, 12, 16, 20]
    for step, loss in logged.items():
        assert _close(losses[step], loss), (step, losses[step], loss)
    print(f"compared {len(logged)} losses and {len(got) + 1} lines")
