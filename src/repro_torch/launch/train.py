"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``src/repro/launch/train.py``: runs the Trainer (checkpoint /
restart, failure recovery, AWF straggler telemetry, DLS-packed data) on
the selected architecture and prints the reference's lines.  The default
is the reduced smoke config; ``--full`` trains the full assigned
configuration.  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from ..configs import ARCHS, get_arch, smoke_config
from ..data.pipeline import DataConfig
from ..optim.adamw import OptimizerConfig
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="train the full assigned config")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu' (the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = smoke_config(cfg)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family}")
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch,
        mean_doc_len=min(512.0, args.seq * 1.2),
        prefix_len=cfg.prefix_len, d_model=cfg.d_model)
    if cfg.prefix_len:
        data_cfg = dataclasses.replace(
            data_cfg, seq_len=args.seq)
        # the model consumes seq tokens + prefix embeddings
    tr = Trainer(
        cfg,
        OptimizerConfig(learning_rate=args.lr, warmup_steps=20,
                        total_steps=args.steps),
        TrainerConfig(steps=args.steps,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=f"{args.ckpt}_{args.arch}",
                      num_microbatches=args.microbatches,
                      log_every=10),
        data_cfg, device=args.device)
    hist = tr.run()
    n = min(10, len(hist))
    first = sum(h["loss"] for h in hist[:n]) / n
    last = sum(h["loss"] for h in hist[-n:]) / n
    print(f"loss first{n}={first:.4f} -> last{n}={last:.4f}; "
          f"checkpoints={tr.store.steps()}")


if __name__ == "__main__":
    main()
