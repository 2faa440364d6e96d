"""DLS-planned gradient-accumulation / batch partitioning.  A NumPy copy of
``src/repro/balance/accum.py``.

Per-worker step times drift (thermals, failed-and-replaced hosts,
congested links).  The paper's AWF weights apply directly: workers are
pods or data-parallel groups, examples are loop iterations, measured step
time is the chunk time.  `AccumPlanner` re-plans each worker's share of
the global batch at step boundaries (the AWF cadence) so a 1.3x-slow
worker receives 1/1.3 of the work instead of stalling the reduction.

The in-step half (equal-size microbatches) lives in train/steps.py; this
host half decides *how many* microbatches each worker runs when the
runtime supports uneven accumulation, or adjusts per-worker example counts
for the data loader.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

from ..core.schedule import ScheduleSpec, resolve
from ..core.torch_sched import balanced_assignment  # noqa: F401 (re-export)

__all__ = ["AccumPlanner"]


@dataclasses.dataclass
class AccumPlanner:
    """AWF-weighted split of the global batch across workers.

    ``schedule`` selects the adaptive weighting technique from the registry
    (any technique exposing per-worker ``weights``, i.e. the AWF family);
    its ``adapt_every`` sets the re-planning cadence in steps.  Resolves
    through the standard path, so ``LB_SCHEDULE`` can override it at launch.
    """

    num_workers: int
    global_batch: int
    min_per_worker: int = 1
    schedule: Union[ScheduleSpec, str] = "awf"

    def __post_init__(self):
        self.spec = resolve(self.schedule, default="awf")
        self._awf = self.spec.make(n=max(self.global_batch, 1),
                                   p=self.num_workers)
        if not (self.spec.meta.adaptive and hasattr(self._awf, "weights")):
            raise ValueError(
                f"AccumPlanner needs a weighted adaptive technique (AWF "
                f"family), got {self.spec.technique!r}")
        self._step = 0
        self.weights = np.ones(self.num_workers)

    def update(self, step_times: np.ndarray) -> np.ndarray:
        """Feed measured per-worker step times; returns new weights."""
        t = np.asarray(step_times, dtype=np.float64)
        shares = self.shares()
        for w in range(self.num_workers):
            # AWF telemetry: time per unit of work for this 'time-step'
            g = self._awf.next_chunk(w)
            if g is None:
                break
            self._awf.complete_chunk(
                w, g, exec_time=float(t[w]) * g.size / max(shares[w], 1))
        # instance rolls every step so telemetry keeps flowing (the AWF
        # accumulators fold at the time-step boundary); the *shares* only
        # refresh at the adapt_every cadence
        self._awf.end_instance()
        self._step += 1
        self._awf.begin_instance(self._step)
        if self._step % self.spec.adapt_every == 0:
            self.weights = self._awf.weights.copy()
        return self.weights

    def shares(self) -> np.ndarray:
        """Integer example counts per worker summing to global_batch."""
        w = self.weights / self.weights.sum()
        raw = w * self.global_batch
        base = np.maximum(np.floor(raw).astype(int), self.min_per_worker)
        # distribute the remainder to the largest fractional parts
        rem = self.global_batch - base.sum()
        if rem > 0:
            frac = raw - np.floor(raw)
            for i in np.argsort(-frac)[:rem]:
                base[i] += 1
        elif rem < 0:
            for i in np.argsort(raw)[: -rem]:
                if base[i] > self.min_per_worker:
                    base[i] -= 1
        # exact fixup
        diff = self.global_batch - base.sum()
        base[int(np.argmax(base))] += diff
        return base
