"""Serving demo on the PyTorch port: batched sampled decoding with a KV
cache + the DLS continuous-batching scheduler routing a ragged request
queue (``examples/serve_demo.py`` on ``repro_torch``).

The keys are the reference's threefry keys (``repro_torch.random``), kept
on the host; the draws run on the logits' device.

    PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init_decode_state, init_decoder
from repro_torch.serve.scheduler import Request, simulate_serving
from repro_torch.train.steps import make_serve_step

SCHEDULERS = ("static", "ss", "fac2", "af")


def decode(device, params=None, *, b: int = 4, steps: int = 32):
    """Sampled decoding of ``b`` lanes for ``steps`` tokens on the smoke
    qwen3-4b; ``params`` default to ``init_decoder(0)``.  Returns the
    (b, steps + 1) tokens (the random first column included) and the wall
    seconds of the decode loop, to a synchronize."""
    dev = resolve_device(device)
    cfg = smoke_config(ARCHS["qwen3-4b"])
    if params is None:
        params, _ = init_decoder(0, cfg, device=dev)
    state = init_decode_state(cfg, b, max_len=64, device=dev)
    serve = make_serve_step(cfg, sample=True, temperature=1.0)
    toks = jr.randint(jr.key(1, device="cpu"), (b, 1), 0, cfg.vocab_size,
                      device=dev)
    rng = jr.key(2, device="cpu")
    out = [toks]
    t0 = time.time()
    for _ in range(steps):
        rng, sub = jr.split(rng)
        toks, state = serve(params, state, toks, sub)
        out.append(toks)
    seqs = torch.cat(out, dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return seqs.cpu(), time.time() - t0


def scheduler_comparison():
    """``simulate_serving`` over a ragged 300-request queue on 8 replicas,
    one 3x slower, for each technique of ``SCHEDULERS``."""
    rng_np = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=0.0,
                    prompt_len=int(rng_np.lognormal(6, 1)),
                    max_new_tokens=int(rng_np.lognormal(4.5, 0.8)))
            for i in range(300)]
    speed = np.ones(8)
    speed[0] = 3.0
    return {t: simulate_serving(reqs, num_workers=8, technique=t,
                                worker_speed=speed) for t in SCHEDULERS}


def device_word(dev: torch.device) -> str:
    return "CPU" if dev.type == "cpu" else torch.cuda.get_device_name(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b, steps = 4, 32
    seqs, dt = decode(dev, b=b, steps=steps)
    print(f"decoded {b}x{steps} tokens in {dt:.2f}s "
          f"({b*steps/dt:.0f} tok/s on {device_word(dev)})")
    print("sample token ids:", seqs[0, :16].numpy())

    print("\nscheduler comparison (8 replicas, one 3x slower):")
    for t, r in scheduler_comparison().items():
        print(f"  {t:7s} makespan={r['makespan']:7.3f}s "
              f"p99={r['p99']:6.3f}s imbalance={r['imbalance']:.3f}")


if __name__ == "__main__":
    main()
