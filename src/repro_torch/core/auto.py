"""Automatic DLS technique selection — the paper's stated future work
(NumPy copy of ``src/repro/core/auto.py`` for the PyTorch port; its graph
engine is the port's torch campaign engine).

LB4OMP §5: "LB4OMP represents the first and necessary step for devising
automated methods to dynamically select the highest performing loop
scheduling techniques during applications execution."  This module is
that step, built on the unified portfolio:

`AutoSelector` treats technique choice per (loop, time-step) as a bandit:
each candidate technique is an arm, the reward is negative parallel loop
time.  Two policies:

  * 'explore_commit' — try each candidate for `explore_steps` time-steps,
    then commit to the best (the paper's experimental campaign, automated
    and amortized over the run);
  * 'ucb' — UCB1 over mean T_par; keeps adapting if the system drifts
    (re-explores when confidence intervals overlap).

`auto_simulate` drives the discrete-event simulator with the selector —
used by benchmarks/auto_select.py and tests/test_auto.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np

from .batch_sim import BatchConfig, simulate_batch
from .schedule import REGISTRY, ScheduleSpec, resolve
from .simulator import OverheadModel, ProfileModel, EXACT_PROFILE, simulate
from .workloads import Workload

__all__ = ["AutoSelector", "auto_simulate", "registry_candidates"]

DEFAULT_CANDIDATES = ("static", "gss", "fac2", "awf_b", "af", "maf", "ss")


def registry_candidates(chunk_param: Optional[int] = None,
                        exclude: Sequence[str] = ()) -> tuple:
    """Every registered technique as an ``AutoSelector`` arm.

    With the batch engine's lockstep band covering the adaptive family,
    evaluating the *full* portfolio is cheap — ``auto_simulate(...,
    engine="batch")`` runs the whole exploration grid vectorized, so
    selection studies (cf. "A Comparative Study of OpenMP Scheduling
    Algorithm Selection Strategies") no longer need to prune adaptive
    arms for wall-clock reasons.  ``chunk_param`` (when given) is applied
    to every arm; ``exclude`` drops techniques by name.
    """
    skip = {e.lower().replace("-", "_") for e in exclude}
    return tuple(
        ScheduleSpec(technique=n) if chunk_param is None
        else ScheduleSpec(technique=n, chunk_param=chunk_param)
        for n in REGISTRY if n not in skip)


@dataclasses.dataclass
class AutoSelector:
    """Bandit over the technique portfolio (one loop's selector).

    Arms are :class:`ScheduleSpec`s — candidates may be given as specs or
    OMP_SCHEDULE-style strings and are validated against the registry at
    construction, so two chunk-param variants of the same technique
    (``"fac2,64"`` vs ``"fac2,512"``) are distinct arms, and user-registered
    plugin techniques are selectable with zero extra wiring.
    """

    candidates: Sequence[Union[str, ScheduleSpec]] = DEFAULT_CANDIDATES
    policy: str = "ucb"          # 'ucb' | 'explore_commit'
    explore_steps: int = 1       # per-candidate exploration budget
    ucb_c: float = 0.5           # exploration strength (relative times)

    def __post_init__(self):
        self.candidates = tuple(resolve(c) for c in self.candidates)
        self._keys = tuple(str(c) for c in self.candidates)
        if len(set(self._keys)) != len(self._keys):
            raise ValueError(f"duplicate candidates: {self._keys}")
        k = len(self.candidates)
        self._n = np.zeros(k, dtype=np.int64)
        self._mean = np.zeros(k)
        self._t = 0
        self._committed: Optional[int] = None

    def _index_of(self, technique: Union[str, ScheduleSpec]) -> int:
        key = str(resolve(technique))
        return self._keys.index(key)

    # -- bandit api -----------------------------------------------------------
    def choose(self) -> ScheduleSpec:
        if self.policy == "explore_commit":
            for i in range(len(self.candidates)):
                if self._n[i] < self.explore_steps:
                    return self.candidates[i]
            # commit exactly once when exploration drains; the cached argmin
            # stays valid until a candidate's stats change (record()
            # invalidates) instead of being recomputed every step
            if self._committed is None:
                self._committed = int(np.argmin(self._mean))
            return self.candidates[self._committed]
        # UCB1 on negative normalized time
        for i in range(len(self.candidates)):
            if self._n[i] == 0:
                return self.candidates[i]
        scale = max(self._mean.max(), 1e-30)
        reward = 1.0 - self._mean / scale          # higher = better
        bonus = self.ucb_c * np.sqrt(
            np.log(max(self._t, 2)) / np.maximum(self._n, 1))
        return self.candidates[int(np.argmax(reward + bonus))]

    def record(self, technique: Union[str, ScheduleSpec],
               t_par: float) -> None:
        i = self._index_of(technique)
        self._n[i] += 1
        self._t += 1
        old = self._mean[i]
        self._mean[i] += (t_par - self._mean[i]) / self._n[i]
        if (self.policy == "explore_commit" and self._committed is not None
                and self._mean[i] != old and i != self._committed):
            # a non-committed arm's stats changed (late telemetry / manual
            # feed): the cached argmin may be stale, recompute lazily
            self._committed = None

    @property
    def best(self) -> ScheduleSpec:
        seen = self._n > 0
        if not seen.any():
            return self.candidates[0]
        means = np.where(seen, self._mean, np.inf)
        return self.candidates[int(np.argmin(means))]

    def summary(self) -> dict:
        return {k: dict(steps=int(n), mean_t_par=float(m))
                for k, n, m in zip(self._keys, self._n, self._mean)}


def _deterministic_prefix(sel: AutoSelector, timesteps: int) -> list[int]:
    """The choice sequence that does not depend on measured rewards.

    Both policies start with reward-free exploration — explore_commit runs
    each arm ``explore_steps`` times, UCB1 runs each unseen arm once — and
    `choose()` during that phase is a pure function of the visit counts.
    Replaying the count bookkeeping yields the exact arm sequence the
    sequential loop would produce, which is what lets the arm-evaluation
    phase run as one vectorized `simulate_batch` grid.
    """
    n = sel._n.copy()
    need = sel.explore_steps if sel.policy == "explore_commit" else 1
    seq: list[int] = []
    for _ in range(timesteps):
        i = next((j for j in range(len(sel.candidates)) if n[j] < need),
                 None)
        if i is None:
            break
        n[i] += 1
        seq.append(i)
    return seq


def auto_simulate(
    workload: Workload,
    p: int,
    timesteps: int,
    *,
    selector: Optional[AutoSelector] = None,
    chunk_param: int = 1,
    speeds=None,
    perturb=None,
    profile: ProfileModel = EXACT_PROFILE,
    overhead: OverheadModel = OverheadModel(),
    seed: int = 0,
    engine: str = "event",
    device=None,
) -> tuple[AutoSelector, list[dict]]:
    """Run `timesteps` loop instances, selecting the technique per step.

    ``engine="batch"`` evaluates every step whose technique choice is
    already determined as one vectorized `simulate_batch` grid instead of
    stepping the event simulator per arm: the reward-free exploration
    prefix for both policies, plus (for explore_commit) the entire
    committed tail.  Results are identical to ``engine="event"`` — the
    batch engine agrees with the oracle and the arm sequence and per-step
    seeds are replayed exactly; only the wall-clock changes.  Adaptive
    arms (AWF*/AF/mAF/BOLD, WF2) run on the lockstep band, so a full-
    registry selector (:func:`registry_candidates`) is evaluated entirely
    through the fast path — no event-oracle fallback.  UCB's
    post-exploration steps stay sequential (each choice depends on the
    previous rewards).

    NOTE: adaptive techniques restart their state on re-selection (a
    selector switch is a new execution context) — matching how a runtime
    would swap OMP_SCHEDULE between time-steps.

    ``engine="graph"`` batches the same way but evaluates the grid with
    the torch campaign engine
    (:func:`repro_torch.core.graph_sim.simulate_batch_graph`): adaptive
    arms run as dense ``(L, p)`` float64 tensors on ``device`` (the card
    unless the caller passes ``"cpu"``), one lane group per
    (technique, p), and everything else falls back to the host bands.
    Graph-band results match the host engines bit-exactly for p < 8 (see
    the cross-form tolerance notes in `core/graph_sim.py`).  ``device``
    is read only by the graph engine.  On the card the graph engine is
    for now launch-bound and slower than ``engine="batch"``.
    """
    if engine not in ("event", "batch", "graph"):
        raise ValueError(
            f"engine must be 'event', 'batch', or 'graph', got {engine!r}")
    sel = selector or AutoSelector()
    history: list[dict] = []

    def _record(spec: ScheduleSpec, rec) -> None:
        sel.record(spec, rec.t_par)
        history.append(dict(step=len(history), technique=str(spec),
                            t_par=rec.t_par, pi=rec.percent_imbalance))

    def _run_batch(specs: list[ScheduleSpec], ts0: int) -> None:
        configs = [
            BatchConfig(technique=s, workload=workload, p=p,
                        chunk_param=chunk_param, speeds=speeds,
                        perturb=perturb, seed=seed + ts0 + k)
            for k, s in enumerate(specs)
        ]
        if engine == "graph":
            from .graph_sim import simulate_batch_graph
            results = simulate_batch_graph(configs, overhead=overhead,
                                           profile=profile, device=device)
        else:
            results = simulate_batch(configs, overhead=overhead,
                                     profile=profile)
        for s, res in zip(specs, results):
            _record(s, res[0].record)

    start = 0
    if engine in ("batch", "graph"):
        prefix = _deterministic_prefix(sel, timesteps)
        _run_batch([sel.candidates[i] for i in prefix], 0)
        start = len(prefix)
        if sel.policy == "explore_commit" and start < timesteps:
            committed = sel.choose()  # commits once; cached hereafter
            _run_batch([committed] * (timesteps - start), start)
            start = timesteps
    for ts in range(start, timesteps):
        spec = sel.choose()
        rec = simulate(spec, workload, p=p, chunk_param=chunk_param,
                       speeds=speeds, perturb=perturb, profile=profile,
                       overhead=overhead, seed=seed + ts)[0].record
        _record(spec, rec)
    return sel, history
