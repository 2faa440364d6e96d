"""Quickstart on the PyTorch port: the paper's DLS techniques in 60
seconds (``examples/quickstart.py`` on ``repro_torch``).

Runs the shared-queue simulator on an irregular loop with every
registered technique, prints the paper's metrics (T_par, c.o.v., p.i.),
then shows the SPMD side: a chunk plan computed with tensor ops on the
card, an AWF weight update there, and the kernel tile planner that drives
the schedule-aware CUDA kernels (see docs/architecture.md).

Technique selection goes through the unified ScheduleSpec interface --
try ``LB_SCHEDULE=gss,64 PYTHONPATH=src python examples/torch_quickstart.py``
to see the env override (the repo's OMP_SCHEDULE) in action.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    TECHNIQUES, best_combination, LoopRecorder, plan_tiles_for_kernel,
    resolve, simulate, sphynx_like,
)
from repro_torch.core.torch_sched import awf_update, plan_chunks
from repro_torch.device import resolve_device


def run(device):
    """Everything the demo prints, as data: the simulator table, the
    runtime schedule, the best technique, the device plan and AWF weights,
    and the kernel tile plans."""
    dev = resolve_device(device)
    w = sphynx_like(n=100_000)
    rec = LoopRecorder()
    table = {t: simulate(t, w, p=20, recorder=rec)[0].record
             for t in sorted(TECHNIQUES)}
    # schedule(runtime): $LB_SCHEDULE picks the technique, like OMP_SCHEDULE
    spec = resolve(None, default="fac2,64")
    runtime = simulate(spec, w, p=20)[0].record
    best = best_combination(rec.summary())

    # the same calculus as tensor ops on the device
    sizes, _, count = plan_chunks("fac2", n=10_000, p=8, device=dev)
    # AWF weights from measured worker times (straggler mitigation)
    p = 4
    wnum = torch.zeros(p, device=dev)
    wden = torch.zeros(p, device=dev)
    k = torch.tensor(0, device=dev)
    times = torch.tensor([2.0, 1.0, 1.0, 1.0], device=dev)  # worker 0 is 2x slow
    sizes_done = torch.ones(p, device=dev) * 100
    for _ in range(3):
        weights, wnum, wden, k = awf_update(wnum, wden, k, times, sizes_done)

    # skewed per-tile costs (a hot expert / a long decode lane); the plan
    # splits the kernel's tiles across 8 persistent CTAs with near-equal work
    costs = np.r_[np.full(8, 64.0), np.full(56, 8.0)]    # 8 hot tiles
    plans = {t: plan_tiles_for_kernel(costs, p=8, technique=t,
                                      overhead_per_chunk=2.0)
             for t in ("static", "ss", "fac2")}
    return dict(workload=w, table=table, spec=spec, runtime=runtime,
                best=best, sizes=sizes.cpu(), count=int(count),
                weights=weights.cpu().numpy(), costs=costs, plans=plans)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)

    # --- 1. the paper: self-scheduling an irregular loop ------------------
    w = out["workload"]
    print(f"loop: {w.name}  mu={w.mu*1e6:.1f}us/iter  cv={w.sigma/w.mu:.2f}")
    print(f"\n{'technique':8s} {'T_par':>9s} {'c.o.v.':>8s} {'p.i.%':>7s} {'chunks':>7s}")
    for t, r in out["table"].items():
        print(f"{t:8s} {r.t_par:9.4f} {r.cov:8.4f} "
              f"{r.percent_imbalance:7.2f} {r.n_chunks:7d}")
    r = out["runtime"]
    print(f"\nschedule(runtime) -> {out['spec']}: T_par={r.t_par:.4f} "
          f"({r.n_chunks} chunks)")
    for loop, row in out["best"].items():
        print(f"\nBest technique: {row['technique']} "
              f"(T_par {row['mean_t_par']:.4f})")

    # --- 2. the framework: the same calculus as tensor ops on the device --
    sizes, count = out["sizes"], out["count"]
    print(f"\nin-graph FAC2 plan: {count} chunks, "
          f"first={int(sizes[0])}, last={int(sizes[count-1])}")
    print(f"AWF weights after 3 steps: {np.round(out['weights'], 3)} "
          f"(slow worker gets less work)")

    # --- 3. the kernels: DLS tile assignment for a persistent kernel ------
    print(f"\nkernel tile plan ({out['costs'].size} tiles, 8 cores):")
    print(f"{'technique':8s} {'t_par':>7s} {'c.o.v.':>8s} {'p.i.%':>7s} {'chunks':>7s}")
    for t, ktp in out["plans"].items():
        print(f"{t:8s} {ktp.t_par:7.1f} {ktp.cov:8.4f} "
              f"{ktp.percent_imbalance:7.2f} {ktp.n_chunks:7d}")
    print("(the same plan feeds grouped_matmul(schedule=...) and "
          "flash_attention(schedule=...) — see README §Kernel scheduling)")


if __name__ == "__main__":
    main()
