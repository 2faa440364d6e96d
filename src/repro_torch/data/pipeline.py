"""Synthetic data pipeline with DLS-balanced packing.  A NumPy copy of
``src/repro/data/pipeline.py``: its batches are byte-identical to the
reference's.

Production shape: deterministic per-step token generation (seeded, so
restart-from-checkpoint replays identical batches), ragged "documents"
with heavy-tailed lengths, and **factoring-packed** batches: documents are
packed into fixed seq_len rows using the paper's chunk calculus
(balanced_assignment / LPT with DLS weights) so that per-row padding waste
is minimized — the data-layer instance of LB4OMP's load balancing.

The host pipeline prefetches batches on a background thread (double
buffering) the way a real input pipeline hides host latency.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticCorpus", "pack_documents", "DataLoader"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: float = 512.0    # lognormal document lengths
    sigma_doc_len: float = 0.8
    prefix_len: int = 0            # modality stub prefix
    d_model: int = 0               # for prefix embedding stubs


class SyntheticCorpus:
    """Deterministic ragged document stream (seeded by (seed, doc_id))."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def doc(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, doc_id))
        ln = int(np.clip(rng.lognormal(np.log(self.cfg.mean_doc_len),
                                       self.cfg.sigma_doc_len), 8, 8 * self.cfg.mean_doc_len))
        # zipf-ish token distribution, ids in [2, vocab)
        toks = rng.zipf(1.3, size=ln) % (self.cfg.vocab_size - 2) + 2
        return toks.astype(np.int32)


def pack_documents(docs: list[np.ndarray], seq_len: int,
                   rows: int) -> tuple[np.ndarray, float]:
    """Pack ragged docs into (rows, seq_len) with LPT/DLS balancing.

    Returns (tokens, padding_fraction).  Documents longer than seq_len are
    split into seq_len chunks first (GSS-style decreasing chunks are not
    needed here: splitting at the row size is optimal); the resulting
    pieces are LPT-assigned to rows (the classic bound the paper's WF
    techniques generalize).
    """
    pieces: list[np.ndarray] = []
    for d in docs:
        for i in range(0, len(d), seq_len):
            pieces.append(d[i:i + seq_len])
    # LPT: longest pieces first onto the least-loaded row
    pieces.sort(key=len, reverse=True)
    loads = np.zeros(rows, dtype=np.int64)
    out = np.zeros((rows, seq_len), dtype=np.int32)
    for p in pieces:
        r = int(np.argmin(loads))
        space = seq_len - loads[r]
        take = min(space, len(p))
        if take > 0:
            out[r, loads[r]:loads[r] + take] = p[:take]
            loads[r] += take
        # leftover dropped (bounded by one piece per row)
    pad_frac = 1.0 - loads.sum() / (rows * seq_len)
    return out, float(pad_frac)


class DataLoader:
    """Deterministic, restartable batch iterator with host prefetch."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2, docs_per_batch_factor: float = 1.3):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        self.step = start_step
        self._factor = docs_per_batch_factor
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make_batch(self, step: int) -> dict:
        cfg = self.cfg
        tokens_needed = cfg.global_batch * cfg.seq_len
        n_docs = int(self._factor * tokens_needed / cfg.mean_doc_len)
        base = step * n_docs
        docs = [self.corpus.doc(base + i) for i in range(n_docs)]
        toks, pad = pack_documents(docs, cfg.seq_len, cfg.global_batch)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = 0
        batch = {"tokens": toks, "labels": labels,
                 "_padding_fraction": pad, "_step": step}
        if cfg.prefix_len > 0:
            rng = np.random.default_rng((cfg.seed, step, 7))
            batch["prefix_embed"] = rng.normal(
                0, 1, (cfg.global_batch, cfg.prefix_len, cfg.d_model)
            ).astype(np.float32)
        return batch

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make_batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = self._q.get()
        self.step = batch["_step"] + 1
        return batch

    def close(self):
        self._stop.set()
