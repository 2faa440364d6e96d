"""Workload generators reproducing the paper's benchmark loops (Table 1);
NumPy copy of ``src/repro/core/workloads.py`` for the PyTorch port.

DIST — the synthetic microbenchmark with five statistical distributions of
FLOP-per-iteration (N = 1,000):

    L0 constant     2.3e8 FLOP
    L1 uniform      [1e3, 7e8] FLOP
    L2 normal       mu = 9.5e8, sigma = 7e7, clipped [6e8, 1.3e9]
    L3 exponential  lambda = 1/3e8 (mean 3e8), clipped [948, 4.5e9]
    L4 gamma        k = 2, theta = 1e8, clipped [4.1e6, 2.7e9]

STREAM — four fine-granularity memory kernels (copy/scale/add/triad) whose
per-iteration cost is bytes/bandwidth-bound and essentially constant; used
to expose scheduling overhead and locality loss (paper Sec. 4.2, Fig. 7/8).

Application-shaped loops — SPHYNX L1-like (mildly irregular, front-loaded)
and GROMACS L0-like (regular, very fine granularity) cost profiles used by
the campaign benchmarks.

Iteration *times* are FLOP / core_speed so that simulated seconds are
meaningful; relative orderings are what the paper's claims rest on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

__all__ = [
    "Workload",
    "dist_loop",
    "DIST_LOOPS",
    "stream_loop",
    "STREAM_LOOPS",
    "sphynx_like",
    "gromacs_like",
    "make_workload",
]

#: simulated core speed in FLOP/s (Broadwell-ish single-core figure);
#: only *relative* times matter for reproduction of the paper's orderings.
CORE_FLOPS = 2.0e9

#: simulated per-core memory bandwidth in B/s for STREAM-like loops.
CORE_BW = 6.0e9


@dataclasses.dataclass(frozen=True)
class Workload:
    """N iteration costs (seconds per iteration) plus provenance."""

    name: str
    costs: np.ndarray  # shape (N,), seconds
    meta: dict

    @property
    def n(self) -> int:
        return int(self.costs.shape[0])

    @property
    def mu(self) -> float:
        return float(self.costs.mean())

    @property
    def sigma(self) -> float:
        return float(self.costs.std(ddof=1)) if self.n > 1 else 0.0

    @property
    def total(self) -> float:
        return float(self.costs.sum())


def _mk(name: str, flops: np.ndarray, **meta) -> Workload:
    costs = np.asarray(flops, dtype=np.float64) / CORE_FLOPS
    return Workload(name=name, costs=costs, meta=dict(meta))


# ---------------------------------------------------------------------------
# DIST (paper Table 1)
# ---------------------------------------------------------------------------


def dist_loop(loop: str, n: int = 1000, seed: int = 0) -> Workload:
    """DIST loop L0..L4 with the paper's exact distribution parameters."""
    rng = np.random.default_rng(seed)
    if loop == "L0":  # constant
        f = np.full(n, 2.3e8)
    elif loop == "L1":  # uniform
        f = rng.uniform(1e3, 7e8, size=n)
    elif loop == "L2":  # normal, clipped
        f = np.clip(rng.normal(9.5e8, 7e7, size=n), 6e8, 1.3e9)
    elif loop == "L3":  # exponential (mean 3e8), clipped
        f = np.clip(rng.exponential(3e8, size=n), 948.0, 4.5e9)
    elif loop == "L4":  # gamma k=2 theta=1e8, clipped
        f = np.clip(rng.gamma(2.0, 1e8, size=n), 4.1e6, 2.7e9)
    else:
        raise KeyError(f"unknown DIST loop {loop!r}")
    return _mk(f"dist-{loop}", f, distribution=loop, n=n, seed=seed)


DIST_LOOPS = ("L0", "L1", "L2", "L3", "L4")


# ---------------------------------------------------------------------------
# STREAM (paper Table 1): fine-granularity, bandwidth-bound, regular
# ---------------------------------------------------------------------------

_STREAM_BYTES = {"copy": 16, "scale": 16, "add": 24, "triad": 24}
_STREAM_FLOP = {"copy": 0, "scale": 1, "add": 1, "triad": 2}


def stream_loop(kernel: str, n: int = 200_000, jitter: float = 0.02,
                seed: int = 0) -> Workload:
    """STREAM kernel loop.  The paper uses N = 80e6; the discrete-event
    simulator is O(#chunks), so we default to a smaller N with identical
    per-iteration cost structure — orderings are granularity-driven, not
    N-driven.  ``jitter`` models measurement noise (sigma/mu)."""
    if kernel not in _STREAM_BYTES:
        raise KeyError(f"unknown STREAM kernel {kernel!r}")
    t_mem = _STREAM_BYTES[kernel] / CORE_BW
    t_flop = _STREAM_FLOP[kernel] / CORE_FLOPS
    base = t_mem + t_flop
    rng = np.random.default_rng(seed)
    costs = base * np.maximum(rng.normal(1.0, jitter, size=n), 0.01)
    return Workload(
        name=f"stream-{kernel}",
        costs=costs,
        meta=dict(kernel=kernel, bytes_per_iter=_STREAM_BYTES[kernel],
                  flop_per_iter=_STREAM_FLOP[kernel], n=n),
    )


STREAM_LOOPS = ("copy", "scale", "add", "triad")


# ---------------------------------------------------------------------------
# Application-shaped loops
# ---------------------------------------------------------------------------


def sphynx_like(n: int = 1_000_000, seed: int = 0) -> Workload:
    """SPHYNX L1-shaped loop: computationally intensive, irregular
    (per-particle neighbour counts vary), stationary across the index
    space — matching the Fig. 2/3 setting (N = 1e6, P = 20)."""
    rng = np.random.default_rng(seed)
    noise = rng.lognormal(mean=0.0, sigma=0.55, size=n)
    f = 2.0e5 * noise
    return _mk(f"sphynx-L1(n={n})", f, n=n, seed=seed, shape="lognormal")


def frontloaded_like(n: int = 100_000, seed: int = 0) -> Workload:
    """Loop with more time-consuming iterations at the beginning — the
    paper's Sec. 3.1 scenario where FAC2 is expected to beat GSS."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n)
    trend = 1.0 + 1.0 * np.exp(-5.0 * x)
    noise = rng.lognormal(mean=0.0, sigma=0.2, size=n)
    f = 2.0e5 * trend * noise
    return _mk(f"frontloaded(n={n})", f, n=n, seed=seed, shape="front-loaded")


def gromacs_like(n: int = 200_000, seed: int = 0) -> Workload:
    """GROMACS L0-shaped loop: very fine granularity, regular; the loop the
    paper uses to expose pure scheduling overhead (Fig. 7)."""
    rng = np.random.default_rng(seed)
    f = 60.0 * np.maximum(rng.normal(1.0, 0.01, size=n), 0.5)  # ~30ns/iter
    return _mk(f"gromacs-L0(n={n})", f, n=n, seed=seed, shape="fine-regular")


def nab_like(n: int = 44_794, seed: int = 0) -> Workload:
    """352.nab-shaped loop (SPEC OMP 2012): moderately irregular pairwise
    interaction loop (N = 44,794 per Table 1)."""
    rng = np.random.default_rng(seed)
    f = 1.0e5 * (0.5 + rng.gamma(3.0, 0.35, size=n))
    return _mk(f"nab(n={n})", f, n=n, seed=seed, shape="gamma-irregular")


_FACTORIES: dict[str, Callable[..., Workload]] = {
    **{f"dist-{l}": (lambda l=l, **kw: dist_loop(l, **kw)) for l in DIST_LOOPS},
    **{f"stream-{k}": (lambda k=k, **kw: stream_loop(k, **kw)) for k in STREAM_LOOPS},
    "sphynx": sphynx_like,
    "frontloaded": frontloaded_like,
    "gromacs": gromacs_like,
    "nab": nab_like,
}


def make_workload(name: str, **kw) -> Workload:
    if name not in _FACTORIES:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(_FACTORIES)}")
    return _FACTORIES[name](**kw)
