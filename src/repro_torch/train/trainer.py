"""Trainer: checkpoint/restart, failure recovery, AWF straggler
re-weighting, throughput telemetry.  Port of ``src/repro/train/trainer.py``.

Fault tolerance model (the reference's):
  * periodic async checkpoints (CheckpointStore);
  * `run()` survives injected step failures: it restores the last
    checkpoint, rebuilds the data iterator at the right step (the pipeline
    is deterministic-by-step) and continues — the node-failure path;
  * the AccumPlanner consumes measured per-step times and re-plans worker
    shares (straggler mitigation) — with a single device this drives
    telemetry only.

The step runs eagerly on ``device`` (the card unless ``"cpu"``); batches
are copied there from the loader's NumPy arrays.  A step's time is taken
after the loss is read back, so it ends with the device's work.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..balance.accum import AccumPlanner
from ..checkpoint.store import CheckpointStore
from ..data.pipeline import DataConfig, DataLoader
from ..device import resolve_device
from ..models import init_decoder
from ..optim.adamw import OptimizerConfig, adamw_init
from .steps import make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep_checkpoints: int = 3
    num_microbatches: int = 1
    log_every: int = 10
    max_failures: int = 3
    num_worker_groups: int = 1  # pods for the AccumPlanner
    # AWF-family ScheduleSpec/string for the straggler re-weighting
    # ("runtime" or None reads $LB_SCHEDULE)
    accum_schedule: object = "awf"


class Trainer:
    def __init__(self, model_cfg, opt_cfg: OptimizerConfig,
                 train_cfg: TrainerConfig, data_cfg: DataConfig,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 device=None):
        self.cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.tc = train_cfg
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self.store = CheckpointStore(train_cfg.checkpoint_dir,
                                     keep=train_cfg.keep_checkpoints)
        self.failure_hook = failure_hook  # test hook: raises to simulate
        self.planner = AccumPlanner(
            num_workers=max(train_cfg.num_worker_groups, 1),
            global_batch=data_cfg.global_batch,
            schedule=train_cfg.accum_schedule)
        self._step_fn = make_train_step(
            model_cfg, opt_cfg, num_microbatches=train_cfg.num_microbatches)
        self.history: list[dict] = []

    # -- state --------------------------------------------------------------
    def init_state(self, seed: int = 0):
        params, _ = init_decoder(seed, self.cfg, device=self.device)
        return params, adamw_init(params)

    def restore_or_init(self, seed: int = 0):
        params, opt = self.init_state(seed)
        latest = self.store.latest_step()
        if latest is None:
            return params, opt, 0
        (params, opt), extra = self.store.restore(latest, (params, opt))
        return params, opt, int(extra.get("next_step", latest))

    def _feed(self, batch) -> dict:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items() if not k.startswith("_")}

    # -- loop ---------------------------------------------------------------
    def run(self, seed: int = 0) -> list[dict]:
        failures = 0
        params, opt, start = self.restore_or_init(seed)
        step = start
        loader = DataLoader(self.data_cfg, start_step=step)
        try:
            while step < self.tc.steps:
                try:
                    batch = next(loader)
                    t0 = time.time()
                    if self.failure_hook is not None:
                        self.failure_hook(step)
                    params, opt, metrics = self._step_fn(
                        params, opt, self._feed(batch))
                    loss = float(metrics["loss"])
                    if np.isnan(loss):
                        raise FloatingPointError(f"NaN loss at step {step}")
                    dt = time.time() - t0
                    # AWF straggler telemetry (per-pod times at scale; one
                    # device feeds the one measured time)
                    self.planner.update(
                        np.full(self.planner.num_workers, dt))
                    rec = dict(step=step, loss=loss, dt=dt,
                               tokens=batch["tokens"].size,
                               padding=batch.get("_padding_fraction", 0.0),
                               shares=self.planner.shares().tolist())
                    self.history.append(rec)
                    if step % self.tc.log_every == 0:
                        print(f"step {step} loss={loss:.4f} "
                              f"{rec['tokens']/max(dt,1e-9):.0f} tok/s",
                              flush=True)
                    step += 1
                    if step % self.tc.checkpoint_every == 0:
                        self.store.save(step, (params, opt),
                                        {"next_step": step})
                except (FloatingPointError, RuntimeError) as e:
                    failures += 1
                    print(f"[trainer] failure at step {step}: {e} "
                          f"({failures}/{self.tc.max_failures})", flush=True)
                    if failures > self.tc.max_failures:
                        raise
                    # recovery: restore last checkpoint, rebuild loader
                    loader.close()
                    params, opt, step = self.restore_or_init(seed)
                    loader = DataLoader(self.data_cfg, start_step=step)
            self.store.save(step, (params, opt), {"next_step": step})
            self.store.wait()
        finally:
            loader.close()
        return self.history
