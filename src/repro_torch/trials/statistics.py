"""Trial statistics: bootstrap CIs, latency percentiles, tolerance gates.

The paper's methodology reports repeated-measurement statistics, not
point estimates; this module is the reduction layer from a cell's
:class:`~repro_torch.trials.executor.TrialResult` list to the numbers a
benchmark gate can check:

  * :func:`bootstrap_ci` — seeded percentile-bootstrap confidence
    interval for any statistic of the per-trial values (vectorized for
    the mean, the common case);
  * :func:`summarize_cell` — per-metric mean + 95% CI across trials;
  * :func:`compare_cells` — matched-pair comparison of two schedules on
    one scenario, with the non-overlapping-CI win criterion;
  * :class:`ToleranceBand` / :func:`check_gates` — the generalized
    gate format (``cluster_balance.py``'s ad-hoc ``HEAVY_TAIL_BAND``
    pair, promoted to a type that still unpacks like one).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "bootstrap_ci",
    "latency_percentiles",
    "summarize_cell",
    "ci_nonoverlap",
    "compare_cells",
    "ToleranceBand",
    "check_gates",
]

#: TrialResult fields a cell summary reduces by default.
DEFAULT_METRICS = ("mean_latency", "p50", "p99", "p999", "makespan")


def bootstrap_ci(values: Sequence[float],
                 stat: Callable[[np.ndarray], float] = np.mean,
                 n_boot: int = 2000, alpha: float = 0.05,
                 seed: int = 0) -> tuple[float, float]:
    """Seeded percentile-bootstrap ``(lo, hi)`` CI of ``stat(values)``.

    Deterministic for a given ``(values, n_boot, alpha, seed)`` — trial
    reports must reproduce byte-identically.  Degenerate samples give a
    *finite* zero-width interval instead of NaN bounds, so quick-gate
    runs with tiny trial counts can never fail a finite-CI check on
    sample size alone: an empty sample is ``(0.0, 0.0)``, and a
    singleton or all-equal sample collapses to ``(v, v)`` (every
    resample is identical, so the zero-width interval is the exact
    bootstrap answer, short-circuited).
    """
    x = np.asarray(values, dtype=np.float64)
    if x.size == 0:
        return (0.0, 0.0)
    if x.size == 1 or bool(np.all(x == x[0])):
        v = float(stat(x))
        return (v, v)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, x.size, size=(int(n_boot), x.size))
    if stat is np.mean:
        stats = x[idx].mean(axis=1)
    else:
        stats = np.array([float(stat(x[row])) for row in idx])
    lo = float(np.percentile(stats, 100.0 * alpha / 2.0))
    hi = float(np.percentile(stats, 100.0 * (1.0 - alpha / 2.0)))
    return (lo, hi)


def latency_percentiles(latencies: Sequence[float]) -> dict:
    """p50/p99/p99.9 of one latency vector (a single trial's requests)."""
    lat = np.asarray(latencies, dtype=np.float64)
    if lat.size == 0:
        return {"p50": 0.0, "p99": 0.0, "p999": 0.0}
    return {"p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)),
            "p999": float(np.percentile(lat, 99.9))}


def summarize_cell(results: Sequence, metrics: Sequence[str] = DEFAULT_METRICS,
                   n_boot: int = 2000, seed: int = 0) -> dict:
    """Reduce one cell's trials to ``{metric: {mean, ci, trials}}``.

    Each metric is the named ``TrialResult`` field, one value per trial
    (the percentiles are *within-trial* request percentiles, so their
    across-trial mean + CI answers "what p99 should I expect from a
    run of this scenario").
    """
    out: dict = {}
    for m in metrics:
        vals = [float(getattr(r, m)) for r in results]
        lo, hi = bootstrap_ci(vals, n_boot=n_boot, seed=seed)
        out[m] = {"mean": float(np.mean(vals)) if vals else math.nan,
                  "ci": [lo, hi], "trials": len(vals)}
    return out


def ci_nonoverlap(a: Sequence[float], b: Sequence[float]) -> bool:
    """True when intervals ``a`` and ``b`` are disjoint."""
    return a[1] < b[0] or b[1] < a[0]


def compare_cells(a: Sequence, b: Sequence, metric: str = "p99",
                  n_boot: int = 2000, seed: int = 0) -> dict:
    """Compare two cells on ``metric`` (lower is better).

    Returns means, CIs, and ``significant`` — the conservative
    non-overlapping-CI criterion the acceptance gate uses (disjoint 95%
    intervals imply a difference at well past the 5% level).
    """
    sa = summarize_cell(a, metrics=(metric,), n_boot=n_boot, seed=seed)[metric]
    sb = summarize_cell(b, metrics=(metric,), n_boot=n_boot, seed=seed)[metric]
    return {
        "metric": metric,
        "a": sa,
        "b": sb,
        "winner": "a" if sa["mean"] <= sb["mean"] else "b",
        "significant": ci_nonoverlap(sa["ci"], sb["ci"]),
    }


@dataclasses.dataclass(frozen=True)
class ToleranceBand:
    """A ``[lo, hi]`` acceptance interval for a gated metric.

    Unpacks like the bare tuple it replaces (``lo, hi = band``), so
    existing gates migrate by swapping the constructor.
    """

    lo: float
    hi: float

    def __post_init__(self):
        if not self.lo <= self.hi:
            raise ValueError(f"empty band: lo={self.lo} > hi={self.hi}")

    def __iter__(self):
        yield self.lo
        yield self.hi

    def contains(self, value: float) -> bool:
        v = float(value)
        return math.isfinite(v) and self.lo <= v <= self.hi

    def check(self, name: str, value: float) -> dict:
        return {"gate": name, "value": float(value), "lo": self.lo,
                "hi": self.hi, "ok": self.contains(value)}


def check_gates(gates: Sequence[tuple[str, float, "ToleranceBand"]],
                ) -> tuple[bool, list[dict]]:
    """Evaluate ``(name, value, band)`` gates; returns (all_ok, rows)."""
    rows = [band.check(name, value) for name, value, band in gates]
    return all(r["ok"] for r in rows), rows
