"""Loop-performance measurement — LB4OMP's KMP_TIME_LOOPS / KMP_PRINT_CHUNKS
features (paper Sec. 3.2) plus the load-imbalance metrics of Table 1:

    c.o.v. = sigma / mu                       (Flynn Hummel et al. 1992)
    p.i.   = (T_par - mu) / T_par * P/(P-1) * 100%   (DeRose et al. 2007)

where mu/sigma are over per-thread finish (busy) times and T_par is the
parallel loop time.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "cov",
    "percent_imbalance",
    "LoopInstanceRecord",
    "LoopRecorder",
]


def cov(thread_times: Sequence[float]) -> float:
    """Coefficient of variation of per-thread execution times.

    Degenerate inputs are defined as perfectly balanced: an empty or
    single-thread measurement (and a zero/negative mean) returns 0.0
    rather than propagating NaN into the Table-1 summaries.
    """
    t = np.asarray(thread_times, dtype=np.float64)
    if t.size == 0:
        return 0.0
    m = t.mean()
    if m <= 0:
        return 0.0
    return float(t.std(ddof=0) / m)


def percent_imbalance(thread_times: Sequence[float],
                      t_par: Optional[float] = None) -> float:
    """p.i. = (T_par - mean) / T_par * P/(P-1) * 100  (paper Table 1)."""
    t = np.asarray(thread_times, dtype=np.float64)
    p = t.shape[0]
    if p < 2:
        return 0.0
    tp = float(t.max() if t_par is None else t_par)
    if tp <= 0:
        return 0.0
    return float((tp - t.mean()) / tp * (p / (p - 1)) * 100.0)


@dataclasses.dataclass
class LoopInstanceRecord:
    """One loop execution instance — the KMP_TIME_LOOPS unit of record."""

    loop: str
    technique: str
    instance: int
    p: int
    n: int
    chunk_param: int
    t_par: float                      # parallel loop time (max finish)
    thread_times: np.ndarray          # busy time per thread
    thread_finish: np.ndarray         # finish timestamp per thread
    n_chunks: int                     # number of scheduling rounds (o_sr)
    sched_time: float                 # total scheduling overhead across threads
    chunks: Optional[list] = None     # KMP_PRINT_CHUNKS payload

    @property
    def cov(self) -> float:
        return cov(self.thread_times)

    @property
    def percent_imbalance(self) -> float:
        return percent_imbalance(self.thread_times, self.t_par)

    def to_dict(self) -> dict:
        d = dict(
            loop=self.loop, technique=self.technique, instance=self.instance,
            p=self.p, n=self.n, chunk_param=self.chunk_param,
            t_par=self.t_par, n_chunks=self.n_chunks,
            sched_time=self.sched_time,
            cov=self.cov, percent_imbalance=self.percent_imbalance,
            thread_times=self.thread_times.tolist(),
            thread_finish=self.thread_finish.tolist(),
        )
        if self.chunks is not None:
            d["chunks"] = [
                dict(worker=c.worker, start=c.start, size=c.size, batch=c.batch)
                for c in self.chunks
            ]
        return d


class LoopRecorder:
    """Collects LoopInstanceRecords; the library's measurement feature.

    ``print_chunks`` mirrors KMP_PRINT_CHUNKS=1 — chunk logs are retained.
    ``save(path)`` mirrors the KMP_TIME_LOOPS file output.
    """

    def __init__(self, print_chunks: bool = False):
        self.print_chunks = print_chunks
        self.records: list[LoopInstanceRecord] = []
        # per-loop record counts, kept in add(): next_instance is O(1)
        # instead of scanning all records (quadratic over a long serving
        # or cluster run that emits one record per admission)
        self._loop_counts: dict[str, int] = {}

    def add(self, record: LoopInstanceRecord) -> None:
        if not self.print_chunks:
            record = dataclasses.replace(record, chunks=None)
        self.records.append(record)
        self._loop_counts[record.loop] = self._loop_counts.get(record.loop, 0) + 1

    def next_instance(self, loop: str) -> int:
        """The next execution-instance index for ``loop`` — producers that
        emit records across call sites (kernel wrappers, balancers) use
        this so per-loop instance ids stay monotone in one recorder."""
        return self._loop_counts.get(loop, 0)

    def by_technique(self) -> dict[str, list[LoopInstanceRecord]]:
        out: dict[str, list[LoopInstanceRecord]] = {}
        for r in self.records:
            out.setdefault(r.technique, []).append(r)
        return out

    def summary(self) -> list[dict]:
        """Mean T_par / c.o.v. / p.i. per (loop, technique) across instances."""
        groups: dict[tuple, list[LoopInstanceRecord]] = {}
        for r in self.records:
            groups.setdefault((r.loop, r.technique, r.chunk_param), []).append(r)
        rows = []
        for (loop, tech, cp), rs in sorted(groups.items()):
            rows.append(dict(
                loop=loop, technique=tech, chunk_param=cp,
                instances=len(rs),
                mean_t_par=float(np.mean([r.t_par for r in rs])),
                mean_cov=float(np.mean([r.cov for r in rs])),
                mean_pi=float(np.mean([r.percent_imbalance for r in rs])),
                mean_chunks=float(np.mean([r.n_chunks for r in rs])),
                mean_sched_time=float(np.mean([r.sched_time for r in rs])),
            ))
        return rows

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([r.to_dict() for r in self.records], f)

    @staticmethod
    def load(path: str) -> list[dict]:
        with open(path) as f:
            return json.load(f)
