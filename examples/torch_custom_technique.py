"""User-defined scheduling on the PyTorch port, end-to-end -- the plugin
path of the unified ScheduleSpec API (``examples/custom_technique.py`` on
``repro_torch``; after Kale et al., arXiv:1906.08911).

Registers a *trapezoid-factoring* variant ("tfrac") entirely outside
``repro_torch.core``: batches of P requests share one chunk, computed
FAC2-style from the remaining work but tapered linearly per batch like
TSS.  The registration makes ``"tfrac"`` a first-class citizen everywhere:

  * ``ScheduleSpec.parse("tfrac,32")`` / ``LB_SCHEDULE=tfrac,32``
  * the discrete-event simulator (``simulate``)
  * the host planner (``plan_schedule`` + elastic ``replan``)
  * the bandit auto-selector (``AutoSelector`` candidates)
  * the device planner (``torch_sched.plan_chunks``), via a bound graph
    form written in torch ops -- checked here against the host reference.

    PYTHONPATH=src python examples/torch_custom_technique.py [--device cpu]
"""

import argparse
import math

import numpy as np
import torch

from repro_torch.core import (
    AutoSelector,
    ScheduleSpec,
    Technique,
    TechniqueSpec,
    auto_simulate,
    bind_graph_form,
    plan_schedule,
    register_technique,
    simulate,
    sphynx_like,
)
from repro_torch.device import resolve_device


def _taper(n: int, p: int) -> tuple[int, int]:
    """(first, per-batch decrement) of the trapezoid."""
    first = max(1, math.ceil(n / (2 * p)))
    return first, max(1, first // 8)


@register_technique
class TrapezoidFactoring(Technique):
    """tfrac: FAC2's remaining-work batches, TSS's linear taper.

    Batch j (= P consecutive requests) hands out

        c_j = max(chunk_param, ceil(R_j / 2P) - j * delta)

    where R_j is the work remaining at the batch head and delta a fixed
    decrement — bolder late-loop shrinkage than FAC2's pure halving.
    """

    spec = TechniqueSpec("tfrac", False, False, "atomic", 2.0)

    def _init(self, **kw):
        del kw
        self._first, self._delta = _taper(self.n, self.p)
        self._reset_batches()

    def _reset_batches(self):
        self._batch = 0
        self._in_batch = 0
        self._batch_rem = self.n

    def _on_begin_instance(self):
        self._reset_batches()

    def _batch_of(self, request_idx: int) -> int:
        return self._batch

    def _chunk_size(self, worker: int) -> int:
        c = math.ceil(self._batch_rem / (2 * self.p)) - self._batch * self._delta
        return max(1, c)

    def _after_grant(self, grant):
        self._in_batch += 1
        if self._in_batch >= self.p:
            self._batch += 1
            self._in_batch = 0
            self._batch_rem = self.remaining


def _tfrac_next(ctx, rem_total, rem_batch, i):
    """Device closed form of the same rule, in torch ops: ``rem_batch`` is a
    0-d float64 tensor on the plan's device, ``i`` the chunk index."""
    first, delta = _taper(ctx.n, ctx.p)
    del first
    j = i // ctx.p
    c = torch.ceil(rem_batch / (2 * ctx.p)).to(torch.int64) - j * delta
    return torch.clamp_min(c, ctx.cp)


# linear taper -> the default geometric round bound underestimates; bind
# the exact worst case (every round at the chunk_param floor) alongside
bind_graph_form("tfrac", next_size=_tfrac_next, batched=True,
                max_chunks=lambda n, p, cp: math.ceil(n / max(cp, 1)) + p)


def run(device):
    """The plugin through every layer; ``device`` holds the device plan."""
    from repro_torch.core.torch_sched import plan_chunks

    spec = ScheduleSpec.parse("tfrac,32")
    # 1. simulator -- untouched core code schedules the plugin
    w = sphynx_like(n=100_000)
    record = simulate(spec, w, p=20)[0].record
    # 2. host planner -- materialized schedule validates (full coverage,
    #    no gaps/overlap) and sizes decrease batch over batch
    plan = plan_schedule(spec, n=100_000, p=20)
    plan.validate()
    sizes = [c.size for c in plan.chunks]
    # 3. device planner -- the bound graph form agrees with the host
    dsizes, _, count = plan_chunks(spec, n=100_000, p=20, device=device)
    dsizes = [int(s) for s in dsizes[: int(count)].cpu()]
    assert dsizes == sizes, "graph form disagrees with host reference"
    # 4. auto-selection -- the plugin competes in the bandit portfolio
    sel = AutoSelector(candidates=("fac2", "gss", "tfrac,32"),
                       policy="explore_commit", explore_steps=2)
    sel, _ = auto_simulate(w, p=20, timesteps=10, selector=sel)
    return dict(spec=spec, record=record, plan=plan, sizes=sizes,
                count=int(count), selector=sel)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(resolve_device(args.device))
    spec = out["spec"]
    print(f"registered plugin technique: {spec} "
          f"(sync={spec.meta.sync}, o_cs={spec.meta.o_cs})")
    r = out["record"]
    print(f"simulate:      T_par={r.t_par:.4f}  chunks={r.n_chunks}  "
          f"p.i.={r.percent_imbalance:.2f}%")
    sizes = out["sizes"]
    print(f"plan_schedule: {out['plan'].n_chunks} chunks, "
          f"first={sizes[0]}, last={sizes[-1]}")
    print(f"plan_chunks:   agrees with host reference ({out['count']} chunks)")
    sel = out["selector"]
    print(f"AutoSelector:  best={sel.best}  "
          f"(means: { {k: round(v['mean_t_par'], 4) for k, v in sel.summary().items()} })")


if __name__ == "__main__":
    main()
