"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Port of ``src/repro/launch/serve.py``.  Boots the DecodeEngine (continuous
batching with DLS admission and lane-isolated KV caches) on the selected
architecture, with random weights from ``--seed``, and pushes a synthetic
ragged request mix through it.  It runs on the card unless ``--device cpu``
is given.  ``--replicas`` > 1, the two-level cluster path, waits for
``serve/cluster.py`` (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..configs import ARCHS, get_arch, smoke_config
from ..core.schedule import resolve
from ..device import resolve_device
from ..models import init_decoder
from ..serve.engine import DecodeEngine, EngineStats
from ..serve.scheduler import Request


def make_requests(n: int, max_len: int, seed: int) -> list[Request]:
    """The synthetic ragged request mix, drawn as the reference draws it."""
    rng = np.random.default_rng(seed)
    return [Request(
        rid=i, arrival=0.0,
        prompt_len=int(rng.integers(4, max_len // 4)),
        max_new_tokens=int(rng.integers(4, max_len // 4)))
        for i in range(n)]


def run_engine(cfg, params, requests: Sequence[Request], *, slots: int,
               max_len: int, technique, device=None
               ) -> tuple[DecodeEngine, EngineStats]:
    """Submit ``requests`` to a fresh DecodeEngine and run it to the end."""
    eng = DecodeEngine(cfg, params, slots=slots, max_len=max_len,
                       technique=technique, device=device)
    for r in requests:
        eng.submit(r)
    return eng, eng.run()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--technique", default=None,
                    help="DLS admission ScheduleSpec, e.g. 'fac2,8' "
                         "(default: $LB_SCHEDULE, else fac2)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas; > 1 (the cluster path) is not "
                         "ported yet")
    ap.add_argument("--kv8", action="store_true",
                    help="int8-quantized KV cache")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu'")
    args = ap.parse_args(argv)

    if args.replicas > 1:
        raise NotImplementedError(
            "--replicas > 1 runs serve/cluster.py, which is not ported yet "
            "(ROADMAP.md, port queue: 'Cluster, elastic, resilience and "
            "trials')")
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = smoke_config(cfg)
    if args.kv8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    dev = resolve_device(args.device)
    spec = resolve(args.technique, default="fac2")
    requests = make_requests(args.requests, args.max_len, args.seed)
    params, _ = init_decoder(args.seed, cfg, device=dev)

    print(f"arch={cfg.name} slots={args.slots} technique={spec} device={dev}")
    eng, stats = run_engine(cfg, params, requests, slots=args.slots,
                            max_len=args.max_len, technique=spec, device=dev)
    print(f"completed={stats.completed}/{args.requests} "
          f"steps={stats.steps} new_tokens={stats.tokens} "
          f"({stats.tok_per_s:.0f} tok/s)")
    print("sample output:", eng.output(0)[:12])
    return 0 if stats.completed == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
