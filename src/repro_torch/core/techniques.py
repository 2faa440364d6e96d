"""Dynamic loop self-scheduling (DLS) chunk calculators — the heart of LB4OMP.

NumPy copy of ``src/repro/core/techniques.py`` for the PyTorch port: the
chunk calculus is host code and stays byte-faithful to the reference
(identical chunks are tested in tests/test_torch_schedule.py).  The
``step_batch`` machinery is kept for the simulators of a later slice; the
graph (campaign) form is not ported yet.

Implements every technique shipped by the paper (Sec. 3.1) behind one
interface, with the exact chunk calculus from the cited literature:

  non-adaptive:  STATIC, SS, GSS, TSS, FSC, FAC, mFAC, FAC2, WF2, TAP
  adaptive:      BOLD, AWF, AWF-B, AWF-C, AWF-D, AWF-E, AF, mAF
  extras (beyond paper, same selection criteria): TFSS, RAND

Semantics mirrored from the paper:
  * the ``chunk_param`` is the *fixed* chunk size for STATIC/SS and a
    *lower-bound threshold* for every other technique (Sec. 3, "Significance
    of chunk parameter");
  * AF/mAF execute a warm-up round with chunks hard-coded to 10 iterations
    (Sec. 4.4);
  * FAC synchronizes via a mutex (batch leader computes, followers reuse);
    mFAC replaces this with an atomic batch counter and per-thread
    recomputation (Sec. 3.1) — both share the same chunk *values*;
  * AWF adapts at time-step boundaries, AWF-B/E at batch boundaries,
    AWF-C/D at chunk boundaries; D and E additionally fold the scheduling
    overhead into the measured chunk time (Sec. 3.1);
  * mAF folds the scheduling overhead into AF's per-chunk timings (Sec. 3.1).

Each technique is a small state machine:

    t = make_technique("fac2", n=..., p=..., chunk_param=...)
    t.begin_instance(instance=0)
    c = t.next_chunk(worker)            # -> ChunkGrant(start, size, batch)
    t.complete_chunk(worker, c, exec_time, sched_time)

The same objects drive (a) the discrete-event shared-queue simulator
(`core/simulator.py` in the reference) that reproduces the paper's
campaign, and (b) the host planner (`core/planner.py`) used by the
framework's balancers.

The adaptive / worker-dependent band (WF2, BOLD, the AWF family, AF/mAF)
is *defined once* per technique as a
:class:`~repro_torch.core.schedule.TechniqueDef` — a chunk-calculus recurrence
plus adaptive-state init/update written over a small numeric-ops façade —
from which this module derives both the scalar host class and the
vectorized lockstep (``step_batch``) machine; the reference's
`core/graph_sim.py` derives a jitted in-graph campaign form (after the user-defined-
scheduling proposal of Kale et al., arXiv:1906.08911: one pluggable
definition, every execution form generated by the runtime).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from .schedule import (
    REGISTRY,
    ScheduleSpec,
    TechniqueDef,
    TechniqueSpec,
    bind_step_batch,
    bind_techdef,
    register_technique,
    resolve,
)

__all__ = [
    "ChunkGrant",
    "Technique",
    "TechniqueSpec",
    "BatchTechnique",
    "make_technique",
    "register_technique",
    "TECHNIQUES",
    "ADAPTIVE_TECHNIQUES",
    "NONADAPTIVE_TECHNIQUES",
    "PROFILING_TECHNIQUES",
    "PAPER_LB4OMP_SET",
]


# ---------------------------------------------------------------------------
# Shared structures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkGrant:
    """One scheduling-round result: ``size`` iterations starting at ``start``."""

    start: int
    size: int
    batch: int  # batch index (factoring-family); == request index otherwise
    worker: int


class Technique:
    """Base class: shared queue bookkeeping + chunk_param threshold logic."""

    spec: TechniqueSpec

    def __init__(self, n: int, p: int, chunk_param: int = 1, **kw):
        if n <= 0 or p <= 0:
            raise ValueError(f"need n>0, p>0, got n={n} p={p}")
        self.n = int(n)
        self.p = int(p)
        self.chunk_param = max(1, int(chunk_param))
        self.scheduled = 0  # iterations handed out so far
        self.request_idx = 0  # atomic request counter
        self.instance = 0  # loop instance (time-step) index
        self._init(**kw)

    # -- subclass hooks ------------------------------------------------------
    def _init(self, **kw) -> None:  # pragma: no cover - trivial
        del kw

    def _chunk_size(self, worker: int) -> int:
        raise NotImplementedError

    # -- public API ----------------------------------------------------------
    @property
    def remaining(self) -> int:
        return self.n - self.scheduled

    def begin_instance(self, instance: int) -> None:
        """Start a new execution instance of the loop (time-step)."""
        self.instance = instance
        self.scheduled = 0
        self.request_idx = 0
        self._on_begin_instance()

    def _on_begin_instance(self) -> None:
        pass

    def _threshold(self, size: int) -> int:
        # chunk_param is a lower bound for every technique except
        # STATIC/SS where it *is* the chunk size (handled in subclasses).
        return max(size, self.chunk_param)

    def next_chunk(self, worker: int) -> Optional[ChunkGrant]:
        if self.remaining <= 0:
            return None
        size = self._chunk_size(worker)
        size = self._threshold(int(size))
        size = max(1, min(size, self.remaining))
        grant = ChunkGrant(
            start=self.scheduled,
            size=size,
            batch=self._batch_of(self.request_idx),
            worker=worker,
        )
        self.scheduled += size
        self.request_idx += 1
        self._after_grant(grant)
        return grant

    def _batch_of(self, request_idx: int) -> int:
        return request_idx

    def _after_grant(self, grant: ChunkGrant) -> None:
        pass

    def complete_chunk(
        self,
        worker: int,
        grant: ChunkGrant,
        exec_time: float,
        sched_time: float = 0.0,
    ) -> None:
        """Telemetry callback — adaptive techniques learn from it."""
        del worker, grant, exec_time, sched_time

    def end_instance(self) -> None:
        """Called at the end of a loop instance (time-step boundary)."""
        pass

    def inherit(self, other: "Technique") -> None:
        """Adopt learned state from a predecessor instance.

        Used when an execution context is re-planned over a different
        iteration count (e.g. the serving scheduler rebuilding its
        technique over a refreshed backlog): adaptive techniques carry
        their measured per-worker statistics forward instead of
        restarting cold.  Base implementation is a no-op; subclasses
        copy whatever telemetry survives a change of ``n`` (anything
        keyed per worker — ``p`` must match).
        """
        del other


# ---------------------------------------------------------------------------
# One definition per technique — the TechniqueDef derivers
# ---------------------------------------------------------------------------
#
# The adaptive / worker-dependent band (WF2, BOLD, the AWF family, AF/mAF)
# defines each chunk calculus exactly once, as a
# :class:`repro_torch.core.schedule.TechniqueDef` whose callables are written over
# a small numeric-ops façade.  Three execution forms are *derived* from
# that single definition:
#
#   scalar — :func:`_make_scalar_class` builds the host ``Technique``
#            subclass ((p,)-shaped NumPy state, `math` transcendentals);
#   batch  — :class:`_TechDefBatch` advances L lockstep lanes with
#            (L, p)-dense state for ``batch_sim._run_lockstep_band``;
#   graph  — the reference's ``core/graph_sim.py`` runs the same
#            callables inside a jitted per-round engine (not ported yet).
#
# Bit-exactness contract (property-tested in tests/test_batch_sim.py and
# tests/test_graph_sim.py): every façade operation is either IEEE-754
# correctly rounded (+ - * / sqrt) or applied with the exact operand order
# and reduction shape of every other form — worker-axis reductions always
# run over exactly p contiguous float64 elements, so NumPy's pairwise
# summation tree is identical for a (p,) row and each row of an (L, p)
# matrix (this is why the lockstep band groups lanes by (technique, p)).
# ``log`` is the one exception: ``np.log`` (SIMD libm) may differ from
# ``math.log`` by 1 ulp, so BOLD sets ``lanewise=True`` — the batch
# deriver steps its lanes one-by-one with scalar ops — and the graph form
# documents a tolerance instead of bit-equality.
#
# Callable conventions (see the TechniqueDef docstring for signatures):
# state is a dict of per-worker ``(..., p)`` arrays and per-lane scalars;
# callables never mutate entries they later read and return a dict of
# *updated* entries, which each deriver folds back into its own storage.


class _ScalarOps:
    """Ops façade for the scalar host form (and BOLD's lanewise batch
    path): per-worker state is ``(p,)`` NumPy, per-lane quantities are
    Python/NumPy scalars.  ``log`` is ``math.log`` — the C-libm rounding
    the scalar reference has always used."""

    log = staticmethod(math.log)
    sqrt = staticmethod(math.sqrt)
    ceil = staticmethod(np.ceil)
    where = staticmethod(np.where)
    maximum = staticmethod(np.maximum)
    minimum = staticmethod(np.minimum)

    @staticmethod
    def f64(x):
        return float(x)

    @staticmethod
    def expand(x):  # worker-axis broadcast helper: scalars broadcast as-is
        return x

    @staticmethod
    def muladd(a, b, c):
        # round(a*b) + c with both roundings guaranteed: the graph façade
        # overrides this to defeat XLA's FMA contraction; the host forms
        # are plain two-op arithmetic already.
        return a * b + c

    @staticmethod
    def freeze(x):
        # identity on the host; the graph façade returns an opaque copy so
        # a product does not get contracted into a downstream add
        return x

    @staticmethod
    def rsum(x):  # reduce over the worker axis
        return np.sum(x)

    @staticmethod
    def rany(x):
        return bool(np.any(x))

    @staticmethod
    def rall(x):
        return bool(np.all(x))

    @staticmethod
    def gather(x, worker):
        return x[worker]

    @staticmethod
    def scatter_add(x, worker, v):
        x = x.copy()
        x[worker] += v
        return x

    @staticmethod
    def scatter_set(x, worker, v):
        x = x.copy()
        x[worker] = v
        return x


class _BatchOps:
    """Ops façade for the lockstep band: per-worker state is ``(L, p)``,
    per-lane quantities are ``(L,)`` columns; ``worker`` is the ``(L,)``
    requesting-worker vector.  Scatters mutate (the deriver owns the
    arrays and folds the returned values back)."""

    log = staticmethod(np.log)
    sqrt = staticmethod(np.sqrt)
    ceil = staticmethod(np.ceil)
    where = staticmethod(np.where)
    maximum = staticmethod(np.maximum)
    minimum = staticmethod(np.minimum)

    @staticmethod
    def f64(x):
        return np.asarray(x, np.float64)

    @staticmethod
    def expand(x):
        return np.asarray(x)[..., None]

    @staticmethod
    def muladd(a, b, c):
        return a * b + c

    @staticmethod
    def freeze(x):
        return x

    @staticmethod
    def rsum(x):
        return np.sum(x, axis=-1)

    @staticmethod
    def rany(x):
        return np.any(x, axis=-1)

    @staticmethod
    def rall(x):
        return np.all(x, axis=-1)

    @staticmethod
    def gather(x, worker):
        return x[np.arange(len(x)), worker]

    @staticmethod
    def scatter_add(x, worker, v):
        x[np.arange(len(x)), worker] += v
        return x

    @staticmethod
    def scatter_set(x, worker, v):
        x[np.arange(len(x)), worker] = v
        return x


def _techdef_family(other) -> Optional[str]:
    """Family tag of another host instance (None for hand-written
    classes) — the ``inherit`` compatibility test across generated
    classes, replacing the old ``isinstance(other, _AWFBase)``-style
    checks."""
    td = getattr(other, "techdef", None)
    return td.family if isinstance(td, TechniqueDef) else None


def _make_scalar_class(tdef: TechniqueDef, class_name: str) -> type:
    """Derive the scalar host ``Technique`` class from a TechniqueDef.

    State entries live as instance attributes under their definition keys
    (``weights``, ``_mean``, ...), so consumers that reach into adaptive
    state — the serving scheduler, ``AccumPlanner``'s weight reads, the
    elastic-inherit tests — see the same surface the hand-written classes
    exposed."""
    ops = _ScalarOps

    class _Scalar(Technique):
        spec = tdef.spec
        techdef = tdef
        cadence = tdef.cadence
        include_overhead = tdef.include_overhead

        def _init(self, **kw):
            st = tdef.init_state(self.p, kw)
            self._state_keys = tuple(st)
            for k, v in st.items():
                setattr(self, k, v)
            self._warmup_grant = False
            if tdef.factoring:
                self._batch = 0
                self._in_batch = 0
                self._batch_remaining = self.n
                self._batch_chunk = self._compute_batch_chunk(self.n)

        # -- state plumbing -------------------------------------------------
        def _state(self) -> dict:
            return {k: getattr(self, k) for k in self._state_keys}

        def _fold(self, upd: dict) -> None:
            for k, v in upd.items():
                setattr(self, k, v)

        def _adapt(self) -> None:
            if tdef.adapt is not None:
                self._fold(tdef.adapt(ops, self._state(), self.p))

        # -- factoring bookkeeping (FAC2 batch rule) ------------------------
        def _compute_batch_chunk(self, remaining: int) -> int:
            return max(1, math.ceil(remaining / (2.0 * self.p)))

        def _batch_of(self, request_idx: int) -> int:
            return self._batch if tdef.factoring else request_idx

        def _on_begin_instance(self):
            if tdef.cadence == "timestep":
                self._adapt()
            if tdef.factoring:
                self._batch = 0
                self._in_batch = 0
                self._batch_remaining = self.n
                self._batch_chunk = self._compute_batch_chunk(self.n)

        def _after_grant(self, grant: ChunkGrant) -> None:
            if not tdef.factoring:
                return
            self._in_batch += 1
            if self._in_batch >= self.p:
                self._batch += 1
                self._in_batch = 0
                self._batch_remaining = self.remaining
                if self._batch_remaining > 0:
                    self._batch_chunk = self._compute_batch_chunk(
                        self._batch_remaining)
                if tdef.cadence == "batch":
                    self._adapt()

        # -- chunk calculus -------------------------------------------------
        def _threshold(self, size: int) -> int:
            # warm-up chunks are "unaffected by the declaration of the
            # chunk parameter" (paper Sec. 4.4)
            if self._warmup_grant:
                return size
            return max(size, self.chunk_param)

        def _chunk_size(self, worker: int) -> int:
            self._warmup_grant = False
            st = self._state()
            if tdef.warming is not None and tdef.warming(ops, st, worker):
                self._warmup_grant = True
                return min(tdef.warmup_chunk, max(1, self.remaining))
            c = tdef.chunk_size(
                ops, st, worker, float(self.remaining), self.p,
                self._batch_chunk if tdef.factoring else None)
            return max(1, int(np.ceil(c)))

        # -- telemetry ------------------------------------------------------
        def complete_chunk(self, worker, grant, exec_time, sched_time=0.0):
            if tdef.on_complete is None or grant.size <= 0:
                return
            t = exec_time + (sched_time if tdef.include_overhead else 0.0)
            self._fold(tdef.on_complete(
                ops, self._state(), worker, grant.size, t, self.p))
            if tdef.cadence == "chunk":
                self._adapt()

        def inherit(self, other: Technique) -> None:
            if tdef.host_inherit is not None:
                tdef.host_inherit(self, other)

    _Scalar.__name__ = class_name
    _Scalar.__qualname__ = class_name
    _Scalar.__doc__ = tdef.doc
    if tdef.warmup_chunk:
        _Scalar.WARMUP_CHUNK = tdef.warmup_chunk
    return _Scalar


class BatchTechnique:
    """Vectorized counterpart of :class:`Technique` for L lockstep lanes.

    The protocol `core/batch_sim.py` drives (and plugins bind via
    :func:`repro_torch.core.schedule.bind_step_batch`):

      machine = factory(n, p, chunk_param, kws)   # arrays are (L,)-shaped
      machine.begin_instance(ts, act)             # act: active lane ids
      sizes = machine.sizes(act, workers, remaining, request_idx)
      batch = machine.granted(act, workers, sizes, remaining_after,
                              request_idx)        # per-grant batch ids
      machine.complete(act, workers, sizes, exec_t, sched_t)
      machine.end_instance(act)

    ``sizes`` returns *thresholded* chunk sizes (the engine applies the
    final ``max(1, min(size, remaining))`` clamp, mirroring
    ``Technique.next_chunk``); ``granted`` is called after the clamp with
    the post-grant remaining, mirroring ``_after_grant``; ``complete``
    mirrors ``complete_chunk`` and runs once per (lane, round) with the
    measured execution/scheduling costs.  ``kws`` is the per-lane keyword
    list the host class's ``_init`` would receive (mu/sigma/h/weights).
    """

    def __init__(self, n: Sequence[int], p: int,
                 chunk_param: Sequence[int], kws: Sequence[dict]):
        self.n = np.asarray(n, np.int64)
        self.L = len(self.n)
        self.p = int(p)
        self.cp = np.asarray(chunk_param, np.int64)
        self._init_batch(list(kws))

    def _init_batch(self, kws: list) -> None:
        del kws

    def begin_instance(self, instance: int, act: np.ndarray) -> None:
        del instance, act

    def sizes(self, act, workers, remaining, request_idx) -> np.ndarray:
        raise NotImplementedError

    def granted(self, act, workers, sizes, remaining_after,
                request_idx) -> np.ndarray:
        # base Technique: batch index == request index
        del act, workers, sizes, remaining_after
        return request_idx

    def complete(self, act, workers, sizes, exec_t, sched_t) -> None:
        del act, workers, sizes, exec_t, sched_t

    def end_instance(self, act: np.ndarray) -> None:
        del act


class _TechDefBatch(BatchTechnique):
    """The lockstep (``step_batch``) form generated from a TechniqueDef.

    One machine advances L lanes of the same technique and worker count
    one chunk round per call, holding every definition-state entry as a
    dense ``(L,)`` / ``(L, p)`` array.  The technique-specific math is the
    TechniqueDef's own callables run under :class:`_BatchOps`; only the
    factoring bookkeeping, the warm-up split, and BOLD's lanewise scalar
    path (``math.log`` rounding) live here.  Lanes inside a machine must
    share ``p`` — see the bit-exactness contract above.
    """

    def __init__(self, tdef: TechniqueDef, n, p, chunk_param, kws):
        self.tdef = tdef
        super().__init__(n, p, chunk_param, kws)

    def _init_batch(self, kws):
        td = self.tdef
        states = [td.init_state(self.p, kw) for kw in kws]  # validates kws
        self._keys = tuple(states[0]) if states else ()
        self.st: dict[str, np.ndarray] = {}
        for k in self._keys:
            vals = [s[k] for s in states]
            if isinstance(vals[0], np.ndarray):
                self.st[k] = np.stack(vals).astype(np.float64)
            elif isinstance(vals[0], (int, np.integer)):
                self.st[k] = np.asarray(vals, np.int64)
            else:
                self.st[k] = np.asarray(vals, np.float64)
        if td.factoring:
            self._batch = np.zeros(self.L, np.int64)
            self._in_batch = np.zeros(self.L, np.int64)
            self._batch_chunk = np.ones(self.L, np.int64)

    # -- state plumbing -----------------------------------------------------
    def _rows(self, rows, full: bool) -> dict:
        # whole-band rounds (the common case) pass the state arrays as-is
        # instead of row-gather copies — same values, fewer allocs
        if full:
            return dict(self.st)
        return {k: v[rows] for k, v in self.st.items()}

    def _fold(self, rows, full: bool, upd: dict) -> None:
        for k, v in upd.items():
            if full:
                self.st[k] = v
            else:
                self.st[k][rows] = v

    def _adapt(self, rows) -> None:
        td = self.tdef
        if td.adapt is None or not len(rows):
            return
        full = len(rows) == self.L
        self._fold(rows, full, td.adapt(_BatchOps, self._rows(rows, full),
                                        self.p))

    # -- factoring bookkeeping (FAC2 batch rule) ------------------------------
    def _fac2_chunk(self, remaining) -> np.ndarray:
        return np.maximum(
            1, np.ceil(remaining / (2.0 * self.p))).astype(np.int64)

    def begin_instance(self, instance, act):
        del instance
        td = self.tdef
        if td.cadence == "timestep":
            self._adapt(act)
        if td.factoring:
            self._batch[act] = 0
            self._in_batch[act] = 0
            self._batch_chunk[act] = self._fac2_chunk(self.n[act])

    def granted(self, act, workers, sizes, remaining_after, request_idx):
        td = self.tdef
        if not td.factoring:
            return request_idx
        del workers, sizes
        batch = self._batch[act].copy()
        ib = self._in_batch[act] + 1
        roll = ib >= self.p
        if not roll.any():  # mid-batch round (the common case)
            self._in_batch[act] = ib
            return batch
        self._in_batch[act] = np.where(roll, 0, ib)
        self._batch[act] = self._batch[act] + roll
        upd = roll & (remaining_after > 0)
        if upd.any():
            rows = act[upd]
            self._batch_chunk[rows] = self._fac2_chunk(remaining_after[upd])
        if td.cadence == "batch":
            self._adapt(act[roll])
        return batch

    # -- chunk calculus -------------------------------------------------------
    def _sizes_lanewise(self, act, workers, remaining):
        # BOLD: math.log is not bit-stable under vectorization, so each
        # lane steps with the scalar ops (exactly the host class's floats)
        td = self.tdef
        out = np.empty(len(act), np.int64)
        for j, li in enumerate(act):
            st = {k: v[li] for k, v in self.st.items()}
            c = td.chunk_size(_ScalarOps, st, int(workers[j]),
                              float(remaining[j]), self.p, None)
            out[j] = max(1, int(np.ceil(c)))
        return np.maximum(out, self.cp[act])

    def sizes(self, act, workers, remaining, request_idx):
        del request_idx
        td = self.tdef
        if td.lanewise:
            return self._sizes_lanewise(act, workers, remaining)
        full = len(act) == self.L
        st = self._rows(act, full)
        if td.warming is not None:
            warm = td.warming(_BatchOps, st, workers)
            if warm.any():
                out = np.empty(len(act), np.int64)
                out[warm] = np.minimum(td.warmup_chunk,
                                       np.maximum(1, remaining[warm]))
                live = ~warm
                if live.any():
                    rows = act[live]
                    # warm-up grants bypass the chunk_param threshold
                    # (Sec. 4.4); live grants apply it below
                    raw = td.chunk_size(
                        _BatchOps, self._rows(rows, False), workers[live],
                        remaining[live].astype(np.float64), self.p, None)
                    out[live] = np.maximum(
                        np.maximum(1, np.ceil(raw).astype(np.int64)),
                        self.cp[rows])
                return out
        bc = None
        if td.factoring:
            bc = self._batch_chunk if full else self._batch_chunk[act]
        raw = td.chunk_size(_BatchOps, st, workers,
                            remaining.astype(np.float64), self.p, bc)
        return np.maximum(
            np.maximum(1, np.ceil(raw).astype(np.int64)),
            self.cp if full else self.cp[act])

    # -- telemetry ------------------------------------------------------------
    def complete(self, act, workers, sizes, exec_t, sched_t):
        td = self.tdef
        if td.on_complete is None:
            return
        t = exec_t + (sched_t if td.include_overhead else 0.0)
        full = len(act) == self.L
        self._fold(act, full, td.on_complete(
            _BatchOps, self._rows(act, full), workers, sizes, t, self.p))
        if td.cadence == "chunk":
            self._adapt(act)


def _techdef_batch_factory(tdef: TechniqueDef):
    def factory(n, p, chunk_param, kws):
        return _TechDefBatch(tdef, n, p, chunk_param, kws)
    return factory


def _cp_bound(n: int, p: int, chunk_param: int) -> int:
    # every non-final grant is >= max(1, chunk_param) iterations, so no
    # instance can issue more grants than this (jax_sched padding bound)
    return math.ceil(n / max(1, chunk_param))


def _cp_bound_warm(n: int, p: int, chunk_param: int) -> int:
    # AF: warm-up grants bypass the chunk_param floor, but completions
    # are fed at grant time, so after at most p warm-up grants every
    # worker has history and the cp floor binds
    return p + math.ceil(n / max(1, chunk_param))


def _def_technique(tdef: TechniqueDef, class_name: str, *,
                   paper_set: bool = False) -> type:
    """Register a TechniqueDef: derive + register the scalar host class,
    bind the generated ``step_batch`` machine, and attach the definition
    itself so the graph deriver (`core/graph_sim.py`) and the docs
    generator can read it off the registry."""
    cls = _make_scalar_class(tdef, class_name)
    register_technique(cls, paper_set=paper_set)
    bind_techdef(tdef.spec.name, tdef)
    bind_step_batch(tdef.spec.name, _techdef_batch_factory(tdef))
    return cls


# ---------------------------------------------------------------------------
# OpenMP-standard baselines
# ---------------------------------------------------------------------------


@register_technique
class Static(Technique):
    """schedule(static[,c]) — one pre-planned round, zero synchronization."""

    spec = TechniqueSpec("static", False, False, "none", 1.0,
                         chunk_exact=True)

    def _init(self, **kw):
        del kw

    def _threshold(self, size: int) -> int:
        return size  # chunk_param is the exact size, not a threshold

    def _chunk_size(self, worker: int) -> int:
        if self.chunk_param > 1:
            return self.chunk_param
        # default: N/P split, remainder spread over the first N%P workers
        base, rem = divmod(self.n, self.p)
        return base + (1 if self._batch_of(self.request_idx) < rem else 0)

    def _batch_of(self, request_idx: int) -> int:
        return request_idx


@register_technique
class SelfScheduling(Technique):
    """SS == schedule(dynamic,c): fixed chunk c (default 1) per request."""

    spec = TechniqueSpec("ss", False, False, "atomic", 1.0,
                         chunk_exact=True)

    def _threshold(self, size: int) -> int:
        return size  # chunk_param is the exact size

    def _chunk_size(self, worker: int) -> int:
        return self.chunk_param


@register_technique
class GSS(Technique):
    """Guided self-scheduling (Polychronopoulos & Kuck 1987): R/P."""

    spec = TechniqueSpec("gss", False, False, "atomic", 2.0)

    def _chunk_size(self, worker: int) -> int:
        return math.ceil(self.remaining / self.p)


@register_technique
class TSS(Technique):
    """Trapezoid self-scheduling (Tzen & Ni 1993): linear decrement.

    first = ceil(N/2P), last = chunk_param (>=1),
    C = ceil(2N/(first+last)), delta = (first-last)/(C-1).
    """

    spec = TechniqueSpec("tss", False, False, "atomic", 2.0)

    def _on_begin_instance(self):
        self._first = max(1, math.ceil(self.n / (2 * self.p)))
        self._last = max(1, self.chunk_param)
        if self._last > self._first:
            self._last = self._first
        self._steps = max(1, math.ceil(2 * self.n / (self._first + self._last)))
        self._delta = (
            (self._first - self._last) / (self._steps - 1) if self._steps > 1 else 0.0
        )

    def _init(self, **kw):
        del kw
        self._on_begin_instance()

    def _chunk_size(self, worker: int) -> int:
        i = self.request_idx
        return max(self._last, int(math.ceil(self._first - i * self._delta)))


# ---------------------------------------------------------------------------
# Dynamic, non-adaptive (LB4OMP additions)
# ---------------------------------------------------------------------------


@register_technique(paper_set=True)
class FSC(Technique):
    """Fixed-size chunking (Kruskal & Weiss 1985).

    Optimal *constant* chunk given profiled iteration-time stats and the
    scheduling overhead h:

        c = ( (sqrt(2) * N * h) / (sigma * P * sqrt(log P)) ) ** (2/3)

    Requires mu/sigma profiling collected before execution (Sec. 3.2).
    """

    spec = TechniqueSpec("fsc", False, True, "atomic", 2.0)

    def _init(self, mu: float = 1.0, sigma: float = 0.0, h: float = 1e-6, **kw):
        del kw
        self.mu = float(mu)
        self.sigma = float(sigma)
        self.h = float(h)
        logp = math.log(max(self.p, 2))
        if self.sigma <= 0.0:
            # perfectly regular loop: overhead argues for the static split
            self._chunk = max(1, math.ceil(self.n / self.p))
        else:
            num = math.sqrt(2.0) * self.n * self.h
            den = self.sigma * self.p * math.sqrt(logp)
            self._chunk = max(1, math.ceil((num / den) ** (2.0 / 3.0)))

    def _chunk_size(self, worker: int) -> int:
        return self._chunk


class _FactoringBase(Technique):
    """Shared batch accounting for the factoring family.

    A batch = P consecutive requests sharing one chunk size computed from
    the iterations remaining at the *start* of the batch.
    """

    def _init(self, **kw):
        del kw
        self._batch = 0
        self._in_batch = 0
        self._batch_remaining = self.n
        self._batch_chunk = self._compute_batch_chunk(self.n, 0)

    def _on_begin_instance(self):
        self._batch = 0
        self._in_batch = 0
        self._batch_remaining = self.n
        self._batch_chunk = self._compute_batch_chunk(self.n, 0)

    def _compute_batch_chunk(self, remaining: int, batch: int) -> int:
        raise NotImplementedError

    def _batch_of(self, request_idx: int) -> int:
        return self._batch

    def _chunk_size(self, worker: int) -> int:
        return self._batch_chunk

    def _after_grant(self, grant: ChunkGrant) -> None:
        self._in_batch += 1
        if self._in_batch >= self.p:
            self._batch += 1
            self._in_batch = 0
            self._batch_remaining = self.remaining
            if self._batch_remaining > 0:
                self._batch_chunk = self._compute_batch_chunk(
                    self._batch_remaining, self._batch
                )


@register_technique(paper_set=True)
class FAC(_FactoringBase):
    """Factoring (Flynn Hummel, Schonberg & Flynn 1992).

    Probabilistically-optimal batch factor:
        b_j = (P / (2 sqrt(R_j))) * (sigma / mu)
        x_j = 1 + b_j^2 + b_j * sqrt(b_j^2 + 2)
        c_j = ceil(R_j / (x_j * P))

    The original implementation guards the batch state with a *mutex*: the
    first thread of a batch computes c_j, followers reuse it.  That cost is
    modelled by the simulator via spec.sync == "mutex".
    """

    spec = TechniqueSpec("fac", False, True, "mutex", 8.0)

    def _init(self, mu: float = 1.0, sigma: float = 0.0, **kw):
        self.mu = max(float(mu), 1e-30)
        self.sigma = max(float(sigma), 0.0)
        super()._init(**kw)

    def _compute_batch_chunk(self, remaining: int, batch: int) -> int:
        b = (self.p / (2.0 * math.sqrt(remaining))) * (self.sigma / self.mu)
        x = 1.0 + b * b + b * math.sqrt(b * b + 2.0)
        return max(1, math.ceil(remaining / (x * self.p)))


@register_technique(paper_set=True)
class MFAC(FAC):
    """mFAC — LB4OMP's improvement of FAC (Sec. 3.1).

    Chunk *values* identical to FAC; the mutex is replaced by an atomic
    batch counter and each thread recomputes the chunk from the counter.
    More compute (higher o_cs would be wrong — same formula, computed by
    everyone) but far cheaper synchronization.
    """

    spec = TechniqueSpec("mfac", False, True, "atomic", 8.0)


@register_technique(paper_set=True)
class FAC2(_FactoringBase):
    """Practical factoring: every batch hands out half the remainder."""

    spec = TechniqueSpec("fac2", False, False, "atomic", 2.0)

    def _compute_batch_chunk(self, remaining: int, batch: int) -> int:
        return max(1, math.ceil(remaining / (2.0 * self.p)))


def _weighted_chunk(ops, st, worker, remaining, p, batch_chunk):
    # WF2 + AWF family: the worker's weight scales the FAC2 batch chunk
    del remaining, p
    return ops.gather(st["weights"], worker) * batch_chunk


def _wf2_init(p: int, kw: dict) -> dict:
    weights = kw.get("weights")
    if weights is None:
        w = np.ones(p, dtype=np.float64)
    else:
        w = np.asarray(list(weights), dtype=np.float64)
        if w.shape != (p,):
            raise ValueError(f"weights must have shape ({p},)")
        if np.any(w <= 0):
            raise ValueError("weights must be positive")
    return {"weights": w * (p / w.sum())}


WF2 = _def_technique(TechniqueDef(
    spec=TechniqueSpec("wf2", False, False, "atomic", 3.0,
                       worker_dependent=True),
    family="wf2",
    init_state=_wf2_init,
    chunk_size=_weighted_chunk,
    factoring=True,
    max_chunks=_cp_bound,
    doc="""Weighted factoring (Flynn Hummel et al. 1996), FAC2-based practical
    variant: worker p receives w_p * (batch chunk).  Weights are fixed for
    the whole execution and normalized to sum to P.
    """,
), "WF2", paper_set=True)


@register_technique(paper_set=True)
class TAP(Technique):
    """Tapering (Lucco 1992) — probabilistic generalization of GSS.

    With v = alpha * sigma/mu and T = R/P:
        c = T + v^2/2 - v * sqrt(2T + v^2/4)
    alpha defaults to 1.3 (~90% confidence), per the DLS literature.
    """

    spec = TechniqueSpec("tap", False, True, "atomic", 4.0)

    def _init(self, mu: float = 1.0, sigma: float = 0.0, alpha: float = 1.3, **kw):
        del kw
        self.mu = max(float(mu), 1e-30)
        self.sigma = max(float(sigma), 0.0)
        self.v = float(alpha) * self.sigma / self.mu

    def _chunk_size(self, worker: int) -> int:
        t = self.remaining / self.p
        v = self.v
        c = t + v * v / 2.0 - v * math.sqrt(2.0 * t + v * v / 4.0)
        return max(1, int(math.ceil(c)))


# ---------------------------------------------------------------------------
# Dynamic, adaptive (LB4OMP additions)
# ---------------------------------------------------------------------------


_LOG_2 = math.log(2.0)


def _bold_init(p: int, kw: dict) -> dict:
    del p
    return {
        "mu": max(float(kw.get("mu", 1.0)), 1e-30),
        "sigma": max(float(kw.get("sigma", 0.0)), 0.0),
        "h": max(float(kw.get("h", 1e-6)), 0.0),
        "_welford_n": 0,
        "_welford_mean": 0.0,
        "_welford_m2": 0.0,
    }


def _bold_chunk(ops, st, worker, remaining, p, batch_chunk):
    del worker, batch_chunk
    q = remaining
    t = q / p
    mu = st["mu"]
    # slack is branch-free: sigma == 0 gives a == 0 and hence s exactly
    # 0.0 (the log argument is clamped >= e, so its value is finite)
    ratio = st["sigma"] / mu
    a = 2.0 * ratio * ratio
    b = 8.0 * a * ops.log(ops.maximum(8.0 * a, 1.0 + 1e-12))
    s = a * ops.log(ops.minimum(ops.maximum(b, math.e), ops.maximum(q, math.e)))
    c1 = st["h"] / (mu * _LOG_2)
    return t + s / 2.0 - ops.sqrt(s * (t + s / 4.0)) + c1


def _bold_complete(ops, st, worker, size, t, p):
    del worker
    per_iter = t / size
    wn = st["_welford_n"] + 1
    d = per_iter - st["_welford_mean"]
    mean = st["_welford_mean"] + d / wn
    m2 = ops.muladd(d, per_iter - mean, st["_welford_m2"])
    live = wn >= max(2, p)
    return {
        "_welford_n": wn,
        "_welford_mean": mean,
        "_welford_m2": m2,
        "mu": ops.where(live, ops.maximum(mean, 1e-30), st["mu"]),
        "sigma": ops.where(
            live, ops.sqrt(m2 / ops.maximum(ops.f64(wn) - 1.0, 1.0)),
            st["sigma"]),
    }


def _bold_host_inherit(self, other) -> None:
    # mu/sigma/h and the Welford accumulator are global (per-
    # iteration) statistics, so they survive a change of p unchanged
    if _techdef_family(other) != "bold":
        return
    self.mu, self.sigma, self.h = other.mu, other.sigma, other.h
    self._welford_n = other._welford_n
    self._welford_mean = other._welford_mean
    self._welford_m2 = other._welford_m2


BOLD = _def_technique(TechniqueDef(
    spec=TechniqueSpec("bold", True, True, "atomic", 16.0),
    family="bold",
    init_state=_bold_init,
    chunk_size=_bold_chunk,
    on_complete=_bold_complete,
    lanewise=True,
    host_inherit=_bold_host_inherit,
    max_chunks=_cp_bound,
    doc="""BOLD (Hagerup 1997) — overhead-aware, variance-aware factoring that
    starts *bolder* (larger early chunks) than FAC to cut scheduling rounds.

    Implementation note (see DESIGN.md §8): Hagerup's published strategy
    keeps a variance "slack" that grows only logarithmically with the
    remaining work and explicitly charges the per-round overhead h.  We use
    the LB4OMP-lineage constants

        a  = 2 sigma^2 / mu^2
        b  = 8 a ln(8 a)          (slack saturation point)
        c1 = h / (mu ln 2)        (overhead in units of iterations)

    and per request, with Q = remaining and t = Q/P:

        s     = a * ln(min(max(b, e), Q))      # bounded variance slack
        chunk = t + s/2 - sqrt(s * (t + s/4)) + c1

    i.e. a TAP-shaped reduction whose slack saturates (boldness) plus an
    additive overhead floor.  Qualitative properties asserted by tests:
    early chunks >= FAC2's, monotone non-increasing, overhead-aware floor.
    BOLD is adaptive in that mu/sigma/h may be re-estimated from completed
    chunks (we update them with Welford online stats).
    """,
), "BOLD", paper_set=True)


_AWF_DOC = """Adaptive weighted factoring family (Banicescu, Velusamy &
    Devaprasad 2003).  FAC2-style batches; worker p's share is scaled by
    an adaptive weight learned from its measured time-per-iteration:

        pi_p   = (sum of chunk times) / (sum of chunk sizes)   per worker
        wap_p  = weighted avg of pi_p over adaptation points (recency-
                 weighted: point k gets weight k)
        w_p    = P * (1/wap_p) / sum_q (1/wap_q)

    Adaptation cadence differs per variant:
        AWF   : at time-step boundaries (begin_instance)
        AWF-B : at batch boundaries            AWF-E : = B + sched overhead
        AWF-C : at every chunk completion      AWF-D : = C + sched overhead
    """


def _awf_init(p: int, kw: dict) -> dict:
    del kw
    return {
        "weights": np.ones(p, dtype=np.float64),
        # per-worker accumulators over the current adaptation window
        "_sum_time": np.zeros(p, dtype=np.float64),
        "_sum_size": np.zeros(p, dtype=np.float64),
        # recency-weighted average state: sum(k * pi_k), sum(k)
        "_wap_num": np.zeros(p, dtype=np.float64),
        "_wap_den": np.zeros(p, dtype=np.float64),
        "_adapt_k": 0,
    }


def _awf_complete(ops, st, worker, size, t, p):
    del p
    return {
        "_sum_time": ops.scatter_add(st["_sum_time"], worker, t),
        "_sum_size": ops.scatter_add(st["_sum_size"], worker, ops.f64(size)),
    }


def _awf_adapt(ops, st, p):
    """Fold the current window into wap and refresh weights.

    Where the scalar reference early-returns (no window data; some worker
    still without history) this masks instead: untouched entries pass
    through ``where`` unchanged, and values computed for discarded
    branches are finite (denominators clamped), so the update is safe and
    bit-identical under scalar, lane-dense, and traced execution.
    """
    mask = st["_sum_size"] > 0
    has = ops.rany(mask)
    k_next = ops.where(has, st["_adapt_k"] + 1, st["_adapt_k"])
    k = ops.expand(ops.f64(k_next))
    pi = ops.where(
        mask, st["_sum_time"] / ops.maximum(st["_sum_size"], 1e-30), 0.0)
    num = ops.where(mask, ops.muladd(k, pi, st["_wap_num"]), st["_wap_num"])
    den = ops.where(mask, st["_wap_den"] + k, st["_wap_den"])
    hasx = ops.expand(has)
    out = {
        "_adapt_k": k_next,
        "_wap_num": num,
        "_wap_den": den,
        "_sum_time": ops.where(hasx, 0.0, st["_sum_time"]),
        "_sum_size": ops.where(hasx, 0.0, st["_sum_size"]),
    }
    # adapt only once every worker has history; den entries are sums of
    # k >= 1 wherever seen, so the clamp never alters a live denominator
    upd = has & ops.rall(den > 0)
    wap = ops.maximum(num / ops.maximum(den, 1e-30), 1e-30)
    inv = 1.0 / wap
    w = p * inv / ops.expand(ops.rsum(inv))
    out["weights"] = ops.where(ops.expand(upd), w, st["weights"])
    return out


def _awf_host_inherit(self, other) -> None:
    if _techdef_family(other) != "awf":
        return
    if other.p == self.p:
        self.weights = other.weights.copy()
        self._sum_time = other._sum_time.copy()
        self._sum_size = other._sum_size.copy()
        self._wap_num = other._wap_num.copy()
        self._wap_den = other._wap_den.copy()
        self._adapt_k = other._adapt_k
        return
    # elastic re-plan over a changed worker count (shrink/grow):
    # workers 0..k-1 keep their measured rate history; on grow, the
    # unseen workers start from the mean inherited wap (a neutral
    # prior — no measured worker is penalized for the newcomers),
    # and the weights renormalize to sum to the new p
    k = min(self.p, other.p)
    for name in ("_sum_time", "_sum_size", "_wap_num", "_wap_den"):
        getattr(self, name)[:k] = getattr(other, name)[:k]
    self._adapt_k = other._adapt_k
    seen = other._wap_den[:k] > 0
    if self.p > other.p and np.any(seen):
        wap = other._wap_num[:k][seen] / other._wap_den[:k][seen]
        self._wap_num[k:] = float(wap.mean())
        self._wap_den[k:] = 1.0
    w = np.ones(self.p)
    w[:k] = other.weights[:k]
    self.weights = self.p * w / w.sum()


def _awf_def(name: str, o_cs: float, cadence: str,
             include_overhead: bool) -> TechniqueDef:
    return TechniqueDef(
        spec=TechniqueSpec(name, True, False, "atomic", o_cs),
        family="awf",
        init_state=_awf_init,
        chunk_size=_weighted_chunk,
        factoring=True,
        cadence=cadence,
        include_overhead=include_overhead,
        on_complete=_awf_complete,
        adapt=_awf_adapt,
        host_inherit=_awf_host_inherit,
        max_chunks=_cp_bound,
        doc=_AWF_DOC,
    )


AWF = _def_technique(_awf_def("awf", 6.0, "timestep", False),
                     "AWF", paper_set=True)
AWF_B = _def_technique(_awf_def("awf_b", 6.0, "batch", False),
                       "AWF_B", paper_set=True)
AWF_C = _def_technique(_awf_def("awf_c", 8.0, "chunk", False),
                       "AWF_C", paper_set=True)
AWF_D = _def_technique(_awf_def("awf_d", 8.0, "chunk", True),
                       "AWF_D", paper_set=True)
AWF_E = _def_technique(_awf_def("awf_e", 6.0, "batch", True),
                       "AWF_E", paper_set=True)


_AF_DOC = """Adaptive factoring (Banicescu & Liu 2000).

    Learns per-worker mean/std of iteration time *during* execution and
    hands worker p a chunk

        c_p = (D + 2 T R - sqrt(D^2 + 4 D T R)) / (2 mu_p)

    with D = sum_q sigma_q^2 / mu_q, T = 1 / sum_q (1/mu_q), R = remaining.
    The first chunk per worker is the hard-coded 10-iteration warm-up the
    paper calls out in Sec. 4.4.
    """


def _af_init(p: int, kw: dict) -> dict:
    del kw
    return {
        "_cnt": np.zeros(p, dtype=np.float64),  # iterations observed
        "_mean": np.zeros(p, dtype=np.float64),
        "_m2": np.zeros(p, dtype=np.float64),
    }


def _af_warming(ops, st, worker):
    # warm up while *any* worker lacks history (subsumes the requesting
    # worker's own check)
    del worker
    return ops.rany(st["_cnt"] < 1)


def _af_chunk(ops, st, worker, remaining, p, batch_chunk):
    del batch_chunk
    mu = ops.maximum(st["_mean"], 1e-30)
    var = ops.where(
        st["_cnt"] > 1, st["_m2"] / ops.maximum(st["_cnt"] - 1.0, 1.0), 0.0)
    d = ops.rsum(var / mu)
    t = 1.0 / ops.rsum(1.0 / mu)
    r = remaining
    c = (ops.muladd(2.0 * t, r, d)
         - ops.sqrt(ops.freeze(d * d) + ops.freeze(4.0 * d * t * r))
         ) / (2.0 * ops.gather(mu, worker))
    # guard: never exceed the GSS envelope R/P — warm-up mu estimates
    # are 10-sample noisy and the first post-warm-up requester is
    # precisely the worker whose mu is most underestimated (selection
    # effect); unbounded, it would grab >1x its fair share in one chunk.
    return ops.minimum(c, ops.ceil(r / p))


def _af_complete(ops, st, worker, size, t, p):
    del p
    per_iter = t / size
    # size-weighted Welford: a chunk of k iterations contributes k
    # observations of its mean per-iteration time (the only quantity the
    # RTL can measure, cf. LB4OMP's RDTSCP chunk timers)
    k = ops.f64(size)
    cnt = ops.gather(st["_cnt"], worker) + k
    d = per_iter - ops.gather(st["_mean"], worker)
    mean = ops.gather(st["_mean"], worker) + d * k / cnt
    return {
        "_cnt": ops.scatter_set(st["_cnt"], worker, cnt),
        "_mean": ops.scatter_set(st["_mean"], worker, mean),
        "_m2": ops.scatter_add(st["_m2"], worker,
                               ops.freeze(k * d * (per_iter - mean))),
    }


def _af_host_inherit(self, other) -> None:
    if _techdef_family(other) != "af":
        return
    if other.p == self.p:
        self._cnt = other._cnt.copy()
        self._mean = other._mean.copy()
        self._m2 = other._m2.copy()
        return
    # elastic re-plan: carry the surviving workers' per-iteration
    # estimators; added workers stay at cnt == 0, so AF's warm-up
    # round (fixed chunks of 10, Sec. 4.4) reruns for exactly them
    k = min(self.p, other.p)
    self._cnt[:k] = other._cnt[:k]
    self._mean[:k] = other._mean[:k]
    self._m2[:k] = other._m2[:k]


def _af_def(name: str, include_overhead: bool, doc: str) -> TechniqueDef:
    return TechniqueDef(
        spec=TechniqueSpec(name, True, False, "atomic", 24.0),
        family="af",
        init_state=_af_init,
        chunk_size=_af_chunk,
        include_overhead=include_overhead,
        on_complete=_af_complete,
        warmup_chunk=10,
        warming=_af_warming,
        host_inherit=_af_host_inherit,
        max_chunks=_cp_bound_warm,
        doc=doc,
    )


AF = _def_technique(_af_def("af", False, _AF_DOC), "AF", paper_set=True)

MAF = _def_technique(_af_def(
    "maf", True,
    """mAF — LB4OMP's improvement of AF (Sec. 3.1): per-chunk timings also
    include the scheduling overhead, so the estimator sees the *true* cost
    per iteration and grows chunks to amortize o_cs."""),
    "MAF", paper_set=True)


# ---------------------------------------------------------------------------
# Beyond-paper extras (same selection criteria, Sec. 2)
# ---------------------------------------------------------------------------


@register_technique
class TFSS(Technique):
    """Trapezoid factoring self-scheduling — beyond-paper extra that meets
    the paper's selection criteria (simple chunk calculation).  Batches of P
    requests share the mean of the TSS bounds for that batch."""

    spec = TechniqueSpec("tfss", False, False, "atomic", 2.0)

    def _init(self, **kw):
        del kw
        self._first = max(1, math.ceil(self.n / (2 * self.p)))
        self._last = 1.0
        self._steps = max(1, math.ceil(2 * self.n / (self._first + self._last)))
        self._delta = (
            (self._first - self._last) / (self._steps - 1) if self._steps > 1 else 0.0
        )

    def _batch_of(self, request_idx: int) -> int:
        return request_idx // self.p

    def _chunk_size(self, worker: int) -> int:
        j = self.request_idx // self.p
        lo = self._first - j * self.p * self._delta
        hi = lo - (self.p - 1) * self._delta
        return max(1, int(math.ceil((lo + hi) / 2.0)))


@register_technique
class Rand(Technique):
    """RAND — uniformly random chunk in [N/(100P), N/(2P)] (related-work
    baseline from Ciorba et al. 2018; beyond-paper extra)."""

    spec = TechniqueSpec("rand", False, False, "atomic", 2.0)

    def _init(self, seed: int = 0, **kw):
        del kw
        self._rng = np.random.default_rng(seed)
        self._lo = max(1, self.n // (100 * self.p))
        self._hi = max(self._lo + 1, self.n // (2 * self.p))

    def _chunk_size(self, worker: int) -> int:
        return int(self._rng.integers(self._lo, self._hi))


@register_technique
class FISS(Technique):
    """Fixed-increase size chunking (beyond-paper extra; the increasing-
    chunk family from the DLS literature).  Chunks grow linearly per
    batch of P requests:

        B      = max(2, ceil(log2(N / P)))        # number of stages
        c_0    = N / ((2 + B) * P)                # first chunk
        delta  = 2 * N * (1 - B / (2 + B)) / (P * B * (B - 1))
        c_j    = c_0 + j * delta

    Rationale (mirrors the paper's selection criteria): early small
    chunks absorb startup imbalance; later large chunks amortize o_sr.
    """

    spec = TechniqueSpec("fiss", False, False, "atomic", 2.0)

    def _init(self, **kw):
        del kw
        b = max(2, math.ceil(math.log2(max(self.n / max(self.p, 1), 2))))
        self._b = b
        self._c0 = max(1.0, self.n / ((2 + b) * self.p))
        self._delta = (2.0 * self.n * (1.0 - b / (2.0 + b))
                       / (self.p * b * (b - 1)))

    def _batch_of(self, request_idx: int) -> int:
        return request_idx // self.p

    def _chunk_size(self, worker: int) -> int:
        j = min(self.request_idx // self.p, self._b - 1)
        return max(1, int(math.ceil(self._c0 + j * self._delta)))


@register_technique
class VISS(FISS):
    """Variable-increase size chunking: like FISS but the increment
    halves every stage (c_j = c_{j-1} + c_0 / 2**j), converging to ~2*c_0
    — gentler tail growth for irregular loops."""

    spec = TechniqueSpec("viss", False, False, "atomic", 2.0)

    def _chunk_size(self, worker: int) -> int:
        j = min(self.request_idx // self.p, 30)
        # c_j = c0 * (1 + sum_{i=1..j} 2^-i) = c0 * (2 - 2^-j)
        return max(1, int(math.ceil(self._c0 * (2.0 - 2.0 ** (-j)))))



# ---------------------------------------------------------------------------
# Registry views — live projections of core.schedule.REGISTRY.  User-defined
# techniques registered with @register_technique appear here automatically.
# ---------------------------------------------------------------------------

#: name -> host reference class (the historical dict, now a registry view)
TECHNIQUES = REGISTRY.class_view()

ADAPTIVE_TECHNIQUES = REGISTRY.names_view(lambda e: e.meta.adaptive)
NONADAPTIVE_TECHNIQUES = REGISTRY.names_view(lambda e: not e.meta.adaptive)
PROFILING_TECHNIQUES = REGISTRY.names_view(lambda e: e.meta.requires_profiling)

#: The 14 techniques the paper counts as LB4OMP's additions.
PAPER_LB4OMP_SET = REGISTRY.names_view(lambda e: e.paper_set)


def make_technique(spec: str | ScheduleSpec, n: int, p: int,
                   chunk_param: Optional[int] = None, **kw) -> Technique:
    """Factory: ``make_technique("fac2", n=10**6, p=20, chunk_param=97)``.

    Deprecation shim over :meth:`ScheduleSpec.make` — accepts a bare name,
    an ``OMP_SCHEDULE``-style string (``"fac2,64"``), or a ``ScheduleSpec``.
    An explicit ``chunk_param`` argument overrides the spec's.
    """
    return resolve(spec, chunk_param=chunk_param).make(n=n, p=p, **kw)
