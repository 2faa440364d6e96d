"""MoE load-balancing demo on the PyTorch port: the paper's AWF technique
as an auxiliary-loss-free expert balancer (router-bias integral control),
plus the schedule-aware grouped-matmul kernel -- the balancer's
ScheduleSpec flows down into the kernel's tile plan and the kernel
telemetry flows back as LoopInstanceRecords (``examples/moe_balance_demo.py``
on ``repro_torch``).

On the card both grouped matmuls run the general CUDA kernel
(``gmm_simt``: fp32 operands, 8-row tiles), one launch each; on the CPU
the plain version.

    PYTHONPATH=src python examples/torch_moe_balance_demo.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.balance.moe import MoEBalancer
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.models.moe import _route, init_moe

STEPS = 15


def config():
    cfg = smoke_config(ARCHS["qwen3-moe-30b-a3b"])
    return dataclasses.replace(cfg, compute_dtype="float32")


def make_stream(cfg, device):
    """The token stream: a hot direction shared by every step plus fresh
    normals a step, drawn with the reference's keys on ``device``."""
    hot = jr.normal(jr.key(99, device="cpu"), (1, 1, cfg.d_model),
                    device=device)

    def stream(step):
        base = jr.normal(jr.fold_in(jr.key(1, device="cpu"), step),
                         (4, 64, cfg.d_model), device=device)
        return base + 1.5 * hot

    return stream


def run(device, params=None, stream=None):
    """The balancer's 15 steps and the two grouped matmuls.  ``params``
    default to ``init_moe`` seeded with 0 and ``stream`` to
    :func:`make_stream`.  Returns the per-step loads, the tile plan, both
    products and the balancer."""
    dev = resolve_device(device)
    cfg = config()
    if params is None:
        params, _ = init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    stream = make_stream(cfg, dev) if stream is None else stream
    e = cfg.moe.num_experts
    bal = MoEBalancer(num_experts=e, bias_strength=0.05,
                      kernel_schedule="fac2")
    p = dict(params)
    p["router_bias"] = torch.zeros((e,), dtype=torch.float32, device=dev)
    loads = []
    for step in range(STEPS):
        load = _route(p, cfg, stream(step))[3].cpu().numpy()
        loads.append(load)
        p["router_bias"] = torch.as_tensor(bal.update(load),
                                           dtype=torch.float32, device=dev)

    # the balancer passes its kernel spec + the measured ragged loads down
    # to the grouped-matmul tile planner, and records the plan telemetry
    rows = np.asarray(load / load.sum() * 256, dtype=int)
    cap = max(8, int(np.ceil(rows.max() / 8)) * 8)
    order, ktp = bal.plan_kernel_tiles(rows, block_rows=8, p=8,
                                       capacity_rows=cap)
    xe = torch.ones((e, cap, cfg.d_model), dtype=torch.float32, device=dev)
    w = torch.ones((e, cfg.d_model, cfg.moe.d_ff), dtype=torch.float32,
                   device=dev)
    out = grouped_matmul(xe, w, tile_order=order, block_rows=8)
    # ...or let the kernel wrapper plan for itself from the same spec:
    out2 = grouped_matmul(xe, w, block_rows=8, schedule=bal.kernel_spec,
                          expert_rows=rows, recorder=bal.kernel_recorder)
    assert torch.equal(out, out2)
    return dict(loads=loads, rows=rows, order=order, ktp=ktp, out=out,
                out2=out2, balancer=bal, experts=e)


def report(res, dev) -> list[str]:
    """The lines the demo prints for the results of :func:`run`."""
    lines = ["step  peak/mean load (1.0 = perfectly balanced)"]
    lines += [f"{step:4d}  {load.max()/load.mean():.3f}"
              for step, load in enumerate(res["loads"])]
    rows, order, ktp = res["rows"], res["order"], res["ktp"]
    lines.append(f"\nDLS tile plan ({ktp.spec}): {len(order)} tiles over "
                 f"{res['experts']} experts (ragged loads {rows.min()}.."
                 f"{rows.max()} rows), {ktp.n_chunks} chunks, kernel p.i. "
                 f"{ktp.percent_imbalance:.1f}%")
    bal = res["balancer"]
    rec = bal.kernel_recorder.records[-1]
    where = ("plain version on CPU" if dev.type == "cpu" else
             f"CUDA kernel on {torch.cuda.get_device_name(dev)}")
    lines.append(f"grouped matmul out: {tuple(res['out'].shape)} ({where}); "
                 f"telemetry: {len(bal.kernel_recorder.records)} kernel "
                 f"records, last cov={rec.cov:.3f}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for line in report(run(dev), dev):
        print(line)


if __name__ == "__main__":
    main()
