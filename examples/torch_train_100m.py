"""End-to-end driver on the PyTorch port: train a ~100M-parameter dense LM
for a few hundred steps on the card, with checkpointing, failure recovery,
DLS data packing, and AWF straggler telemetry -- the production loop at
laptop scale (``examples/train_100m.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] [--device cpu]
"""

import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_train100m")


def make_100m() -> ModelConfig:
    return ModelConfig(
        name="demo-100m",
        family="dense",
        num_layers=8,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        d_ff=2048,
        vocab_size=8192,
        tie_embeddings=True,
        remat="none",
    )


def train(*, steps: int = 300, batch: int = 8, seq: int = 256,
          ckpt: str = CKPT, device="cuda", init_state=None):
    """Run the Trainer; ``init_state`` replaces ``Trainer.init_state`` (a
    carried-over start).  Returns (history, trainer)."""
    cfg = make_100m()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, mean_doc_len=300.0)
    tr = Trainer(
        cfg,
        OptimizerConfig(learning_rate=3e-4, warmup_steps=20,
                        total_steps=steps),
        TrainerConfig(steps=steps, checkpoint_every=50,
                      checkpoint_dir=ckpt, log_every=10),
        data_cfg, device=device,
    )
    if init_state is not None:
        tr.init_state = init_state
    return tr.run(), tr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"model: {make_100m().param_count()/1e6:.1f}M params")
    hist, tr = train(steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt=args.ckpt, device=args.device)
    first = sum(h["loss"] for h in hist[:10]) / 10
    last = sum(h["loss"] for h in hist[-10:]) / 10
    print(f"\nloss: first10={first:.4f} -> last10={last:.4f}")
    assert last < first, "loss should decrease"
    print(f"checkpoints: {tr.store.steps()} in {args.ckpt}")


if __name__ == "__main__":
    main()
