"""Elastic restart demo on the PyTorch port: train, lose a "pod", restart
on fewer workers (``examples/elastic_restart.py`` on ``repro_torch``).

Shows the full fault-tolerance path at laptop scale: checkpoints are
mesh-agnostic (logical arrays), the data pipeline is deterministic by
step, the DLS planner re-plans shares for the new worker count, and
adaptive techniques *inherit* their learned per-worker telemetry across
the shrink/grow (``Technique.inherit``) -- the paper's self-scheduling
argument applied at pod scale.

``elastic_handoff`` is the re-plan + inherit path on its own (no torch,
no training loop), from ``repro_torch.serve.elastic``.

    PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.serve.elastic import elastic_handoff
from repro_torch.train.trainer import Trainer, TrainerConfig

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_elastic_demo")


def config() -> ModelConfig:
    return ModelConfig(name="demo-20m", family="dense", num_layers=4,
                       d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024,
                       vocab_size=4096, tie_embeddings=True, remat="none")


def phase1(device, ckpt=None, init_state=None) -> Trainer:
    """The "4-pod" run that dies at step 12 and recovers from step 12's
    checkpoint, in ``ckpt`` (default ``CKPT``); ``init_state`` replaces
    ``Trainer.init_state``."""
    cfg = config()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                          global_batch=8, mean_doc_len=160.0)
    die = {12}

    def failure(step):
        if step in die:
            die.discard(step)
            raise RuntimeError("pod 3 lost (injected)")

    tr = Trainer(cfg, OptimizerConfig(learning_rate=1e-3, warmup_steps=2),
                 TrainerConfig(steps=16, checkpoint_every=4,
                               checkpoint_dir=ckpt or CKPT, log_every=4,
                               num_worker_groups=4, max_failures=1),
                 data_cfg, failure_hook=failure, device=device)
    if init_state is not None:
        tr.init_state = init_state
    tr.run()
    return tr


def phase2(device, ckpt=None, init_state=None):
    """The restart on 3 worker groups from phase 1's last checkpoint:
    (history, trainer)."""
    cfg = config()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                          global_batch=8, mean_doc_len=160.0)
    tr = Trainer(cfg, OptimizerConfig(learning_rate=1e-3, warmup_steps=2),
                 TrainerConfig(steps=24, checkpoint_every=8,
                               checkpoint_dir=ckpt or CKPT, log_every=4,
                               num_worker_groups=3),
                 data_cfg, device=device)
    if init_state is not None:
        tr.init_state = init_state
    return tr.run(), tr


def handoff():
    """The DLS view: the re-planned loads on 3 workers and the AWF-B
    weights before and after the 4 -> 3 handoff."""
    new_plan, old, new = elastic_handoff()
    loads = np.zeros(3)
    for c in new_plan.chunks:
        loads[c.worker] += c.size
    return new_plan, loads, old, new


def summary(hist, handed) -> list[str]:
    """The lines printed after phase 2 for its history and :func:`handoff`."""
    new_plan, loads, old, new = handed
    return [f"resumed at step {hist[0]['step']}, finished at "
            f"{hist[-1]['step']}, final shares={hist[-1]['shares']}",
            f"\nDLS replan: {new_plan.n} remaining iterations re-balanced "
            f"onto 3 workers -> loads {loads.astype(int).tolist()}",
            f"AWF-B handoff 4 -> 3 workers: old weights "
            f"{np.round(old.weights, 3).tolist()} -> inherited "
            f"{np.round(new.weights, 3).tolist()}"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("=== phase 1: 4 worker groups, failure injected at step 12 ===")
    tr1 = phase1(args.device)
    print(f"phase 1 checkpoints: {tr1.store.steps()}")

    print("\n=== phase 2: restart from checkpoint with 3 worker groups ===")
    hist, _ = phase2(args.device)
    for line in summary(hist, handoff()):
        print(line)


if __name__ == "__main__":
    main()
