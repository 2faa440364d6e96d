"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Port of ``src/repro/launch/serve.py``.  Boots the DecodeEngine (continuous
batching with DLS admission and lane-isolated KV caches) on the selected
architecture, with random weights from ``--seed``, and pushes a synthetic
ragged request mix through it.  It runs on the card unless ``--device cpu``
is given.

With ``--replicas N`` the launcher runs the two-level cluster path
(``serve/cluster.py``): a ``ClusterRouter`` distributes the request stream
across N replica engines with the ``--node-technique`` schedule (a replica
pull is a node-sized chunk; replicas report their decode steps back, so
adaptive node techniques learn replica throughput), and each replica's
engine keeps its own intra-node ``--technique``.  The replicas run one
after another on the one device and share one copy of the weights.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..configs import ARCHS, get_arch, smoke_config
from ..core.metrics import cov, percent_imbalance
from ..core.schedule import resolve
from ..device import resolve_device
from ..models import init_decoder
from ..models.layers import dtype_of
from ..serve.cluster import ClusterRouter
from ..serve.engine import DecodeEngine, EngineStats, prepare_params
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


def run_cluster(cfg, params, spec, node_spec, *, replicas: int, slots: int,
                max_len: int, requests: Sequence[Request],
                device=None) -> dict:
    """Two-level serving: node-level DLS over replica DecodeEngines.

    Port of the reference's ``launch/serve.py:run_cluster``; returns the
    same dict.  The replica engines run one node-sized chunk at a time,
    one after another on ``device``.  The router's measured unit is decode
    steps — the same unit the engines feed their intra-node scheduler.
    The compute-dtype weights are prepared once and shared by every
    engine.
    """
    dev = resolve_device(device)
    shared = prepare_params(params, dtype_of(cfg.compute_dtype), dev)
    engines = [DecodeEngine(cfg, shared, slots=slots, max_len=max_len,
                            technique=spec, device=dev)
               for _ in range(replicas)]
    router = ClusterRouter(replicas, schedule=node_spec)
    for r in requests:
        router.submit(r)
    steps = np.zeros(replicas)
    completed = tokens = 0
    while True:
        rep = int(np.argmin(steps))
        chunk = router.pull(rep)
        if not chunk:
            break
        for q in chunk:
            engines[rep].submit(q)
        stats = engines[rep].run()
        router.complete(rep, busy=float(stats.steps))
        steps[rep] += stats.steps
        completed += stats.completed
        tokens += stats.tokens
    return dict(completed=completed, tokens=tokens,
                replica_steps=steps.tolist(),
                replica_requests=router.replica_requests.tolist(),
                node_chunks=router.node_chunks,
                cross_node_cov=cov(steps),
                cross_node_pi=percent_imbalance(steps))


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
                    help="serving replicas; >1 enables the two-level "
                         "cluster path (node-level DLS over engines)")
    ap.add_argument("--node-technique", default="awf_b",
                    help="node-level ScheduleSpec for --replicas > 1 "
                         "(a replica pull is a node-sized chunk)")
    ap.add_argument("--kv8", action="store_true",
                    help="int8-quantized KV cache")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = smoke_config(cfg)
    if args.kv8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    dev = resolve_device(args.device)
    spec = resolve(args.technique, default="fac2")
    requests = make_requests(args.requests, args.max_len, args.seed)
    params, _ = init_decoder(args.seed, cfg, device=dev)

    if args.replicas > 1:
        node_spec = resolve(args.node_technique, default="awf_b")
        print(f"arch={cfg.name} replicas={args.replicas} slots={args.slots} "
              f"schedule={node_spec}/{spec} device={dev}")
        out = run_cluster(cfg, params, spec, node_spec,
                          replicas=args.replicas, slots=args.slots,
                          max_len=args.max_len, requests=requests,
                          device=dev)
        print(f"completed={out['completed']}/{args.requests} "
              f"tokens={out['tokens']} node_chunks={out['node_chunks']} "
              f"replica_requests={out['replica_requests']}")
        print(f"cross-node steps c.o.v.={out['cross_node_cov']:.3f} "
              f"p.i.={out['cross_node_pi']:.1f}%")
        return 0 if out["completed"] == args.requests else 1

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
