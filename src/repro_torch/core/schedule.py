"""Unified scheduling interface: ``ScheduleSpec`` + the technique registry.

Copy of ``src/repro/core/schedule.py`` for the PyTorch port, kept
byte-faithful so both packages resolve the same specs to the same
registry entries.  The port's ``torch_sched`` binds the closed graph
forms and ``graph_sim`` the campaign forms, as the reference's modules
do; the docs generator (``python -m repro.core.schedule --doc``) stays
with the reference.

This is the repo's ``OMP_SCHEDULE`` / user-defined-scheduling API (after
Kale et al., "Toward a Standard Interface for User-Defined Scheduling in
OpenMP", arXiv:1906.08911).  Every layer that picks a DLS technique —
simulator, planner, auto-selector, serving admission, MoE balancer,
grad-accum planner, benchmarks — accepts ``ScheduleSpec | str`` and funnels
it through one :func:`resolve` path:

    spec = ScheduleSpec.parse("fac2,64")        # OMP_SCHEDULE-style text
    spec = resolve("runtime")                   # read $LB_SCHEDULE
    spec = resolve(None, default="fac2")        # env override, else default
    tech = spec.make(n=100_000, p=20)           # host reference instance

New techniques plug in *without touching core*:

    @register_technique(paper_set=False)
    class MyTechnique(Technique):
        spec = TechniqueSpec("mine", False, False, "atomic", 2.0)
        ...

which makes ``"mine"`` valid everywhere a technique name is accepted —
``simulate``, ``plan_schedule``, ``AutoSelector`` candidates, serving, and
(if a graph form is bound via :func:`bind_graph_form`) the in-graph
``jax_sched.plan_chunks`` planner.

The registry is the single source of truth: ``TECHNIQUES``,
``ADAPTIVE_TECHNIQUES``, ``PAPER_LB4OMP_SET`` and jax_sched's dispatch
table are *live views* of it, not hand-maintained parallel lists.

This module deliberately imports neither ``techniques`` nor ``jax`` — the
host reference classes and the in-graph closed forms both register *into*
it, keeping the JAX dependency optional at this layer.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Iterator, Mapping, Optional, Sequence

__all__ = [
    "LB_SCHEDULE_ENV",
    "ScheduleSpec",
    "TechniqueSpec",
    "TechniqueDef",
    "GraphForm",
    "TechniqueEntry",
    "TechniqueRegistry",
    "REGISTRY",
    "register_technique",
    "bind_graph_form",
    "bind_graph_step",
    "bind_step_batch",
    "bind_techdef",
    "resolve",
]

#: Environment variable mirroring ``OMP_SCHEDULE`` for ``schedule(runtime)``.
LB_SCHEDULE_ENV = "LB_SCHEDULE"

#: OpenMP-standard names accepted as aliases for portfolio techniques.
_ALIASES = {"dynamic": "ss", "guided": "gss", "dls+steal": "dls_steal"}


def _canon(name: str) -> str:
    key = name.strip().lower().replace("-", "_")
    return _ALIASES.get(key, key)


@dataclasses.dataclass(frozen=True)
class TechniqueSpec:
    """Static description used by the simulator's overhead model (Sec. 4.2).

    ``o_cs`` is the *relative* cost of one chunk-size calculation and
    ``sync`` the synchronization primitive the technique needs on a shared
    queue.  These mirror the paper's three-factor overhead decomposition
    (o_sr, o_cs, o_sync) and are calibrated in `core/simulator.py`.

    ``worker_dependent`` marks techniques whose chunk *sizes* depend on the
    identity of the requesting worker (e.g. WF2's fixed per-worker
    weights).  Together with ``adaptive`` (sizes depend on measured
    telemetry) it tells the batch engine (`core/batch_sim.py`) whether the
    chunk sequence is a pure function of (technique, n, p, params, seed)
    and can therefore be precomputed — plugin techniques whose sizes vary
    per worker must set it to stay exact under ``simulate_batch``.
    """

    name: str
    adaptive: bool
    requires_profiling: bool
    sync: str  # "none" | "atomic" | "mutex"
    o_cs: float  # relative chunk-calculation cost (1.0 == one FLOP-ish op)
    worker_dependent: bool = False
    #: ``chunk_param`` is the *exact* chunk size (static/ss family) rather
    #: than the lower-bound threshold every other technique treats it as
    #: (paper Sec. 3, "Significance of chunk parameter").  Consumed by the
    #: docs generator so the reference reads this off the registry.
    chunk_exact: bool = False
    #: work-stealing technique (`core/stealing.py`): per-worker deques
    #: with victim polling instead of a central chunk queue.  Chunk
    #: *positions* come from the state machine (grants need not be
    #: contiguous in request order), the simulators charge ``o_steal``
    #: per victim probe, and `ClusterRouter` switches to replica-to-
    #: replica request migration when the node level sets this.
    stealing: bool = False


@dataclasses.dataclass(frozen=True)
class GraphForm:
    """In-graph (jit-compatible) form of a technique's chunk calculus.

    Either a full ``builder(ctx) -> (sizes, starts, count)`` for techniques
    whose schedule has a direct array form, or a per-request
    ``next_size(ctx, rem_total, rem_batch, chunk_index) -> size`` consumed
    by the generic ``lax.while_loop`` planner in ``core/jax_sched``.
    ``batched`` marks the factoring family (chunk frozen per batch of P).
    ``max_chunks(n, p, chunk_param)`` overrides the default padding bound
    for techniques whose round count the generic geometric estimate
    underestimates (e.g. linear-taper plugins).

    ``step`` is the *campaign* form: a jit-traceable per-round step for the
    adaptive/worker-dependent band, consumed by the ``lax.scan`` engine in
    ``core/graph_sim.simulate_batch_graph``.  A step-only form (``builder``
    and ``next_size`` both None) cannot plan a schedule up front — the
    chunk sequence depends on measured telemetry — so ``plan_chunks`` keeps
    raising ``KeyError`` for it; only the campaign engine uses it.
    """

    builder: Optional[Callable[..., Any]] = None
    next_size: Optional[Callable[..., Any]] = None
    batched: bool = False
    max_chunks: Optional[Callable[[int, int, int], int]] = None
    step: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class TechniqueDef:
    """One *form-generating* definition of a technique's chunk calculus.

    The adaptive/worker-dependent family (AWF variants, AF, mAF, BOLD,
    WF2) defines its recurrence exactly once here — state init, chunk-size
    rule, completion update, and adaptation — expressed over a small
    numeric-ops façade (``ops``) so the same callables run as:

    - the scalar host ``Technique`` class (NumPy ``(p,)`` state),
    - the lockstep ``step_batch`` machine (``(L, p)`` lane-dense state),
    - the in-graph campaign form (jax arrays under ``vmap``/``lax.scan``).

    All three forms are derived by ``repro.core.techniques`` (scalar +
    batch) and ``repro.core.graph_sim`` (graph); registering the def via
    :func:`bind_techdef` is what makes a technique eligible for the
    jitted campaign engine.

    Callable signatures (``st`` is a mutable state mapping; values are
    rebound, never mutated in place, so jax tracing works):

    - ``init_state(p, kw) -> dict`` — fresh per-instance adaptive state;
      validates user kwargs (e.g. WF2's weight vector) for every form.
    - ``chunk_size(ops, st, worker, remaining, p, batch_chunk) -> c`` —
      the *raw* chunk-calculus value; each deriver applies the common
      ``max(1, ceil(c))`` + chunk-param threshold + remaining clamp.
    - ``on_complete(ops, st, worker, size, t, p)`` — fold one measured
      chunk (``t`` already includes scheduling overhead iff
      ``include_overhead``) into the state.
    - ``adapt(ops, st, p)`` — the cadence-triggered weight update.
    - ``host_inherit(self, other)`` — elastic handoff on the scalar class.
    - ``max_chunks(n, p, chunk_param) -> int`` — sound bound on the number
      of grants any single instance can issue (jax_sched padding).

    ``family`` groups variants sharing state layout (all AWF cadences are
    ``"awf"``; AF and mAF are ``"af"``) — ``inherit`` matches on it.
    ``factoring`` selects the FAC2 batch rule for ``batch_chunk``;
    ``cadence`` is when ``adapt`` fires (``"timestep"``/``"batch"``/
    ``"chunk"``/``"none"``); ``warmup_chunk`` > 0 is AF's fixed-size
    warm-up grant (bypasses the chunk-param threshold) issued while
    ``warming(ops, st, worker)`` holds — a *state-dependent* predicate
    (AF warms until every worker has one timing), not a request-count
    cutoff; ``lanewise`` forces the batch band to step lanes one-by-one
    with scalar math so ``math.log`` rounding matches the scalar form
    (BOLD).
    """

    spec: TechniqueSpec
    family: str
    init_state: Callable[..., dict]
    chunk_size: Callable[..., Any]
    factoring: bool = False
    cadence: str = "none"  # "timestep" | "batch" | "chunk" | "none"
    include_overhead: bool = False
    on_complete: Optional[Callable[..., Any]] = None
    adapt: Optional[Callable[..., Any]] = None
    warmup_chunk: int = 0
    warming: Optional[Callable[..., Any]] = None
    lanewise: bool = False
    host_inherit: Optional[Callable[..., Any]] = None
    max_chunks: Optional[Callable[[int, int, int], int]] = None
    doc: str = ""


@dataclasses.dataclass
class TechniqueEntry:
    """One registered technique: host class + graph form + metadata.

    ``step_batch`` is the vectorized lane-parallel form consumed by the
    batch engine's lockstep band (`core/batch_sim.py`): a factory
    ``factory(n, p, chunk_param, kws) -> machine`` advancing L lanes of
    this technique one chunk round at a time with dense per-lane state
    (see :class:`repro.core.techniques.BatchTechnique`).  Bound with
    :func:`bind_step_batch`, next to the in-graph :class:`GraphForm`.

    ``techdef`` is the single form-generating :class:`TechniqueDef` the
    scalar class, the ``step_batch`` machine, and the in-graph campaign
    form were derived from (None for techniques still defined as
    hand-written classes, e.g. the non-adaptive plan band).
    """

    name: str
    cls: type
    meta: TechniqueSpec
    graph: Optional[GraphForm] = None
    step_batch: Optional[Callable] = None
    paper_set: bool = False  # one of the paper's 14 LB4OMP additions
    techdef: Optional[TechniqueDef] = None


class TechniqueRegistry(Mapping):
    """Name -> :class:`TechniqueEntry`; the pluggable technique portfolio.

    Iteration order == registration order (the portfolio order the paper
    tables use).  Mapping lookups canonicalize names (case, ``-`` vs ``_``,
    OpenMP aliases), and a miss raises ``KeyError`` listing valid names.
    """

    def __init__(self) -> None:
        self._entries: dict[str, TechniqueEntry] = {}

    # -- Mapping protocol ----------------------------------------------------
    def __getitem__(self, name: str) -> TechniqueEntry:
        key = _canon(name)
        try:
            return self._entries[key]
        except KeyError:
            raise KeyError(
                f"unknown technique {name!r}; known: {sorted(self._entries)}"
            ) from None

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: object) -> bool:
        return isinstance(name, str) and _canon(name) in self._entries

    # -- registration --------------------------------------------------------
    def register(self, cls=None, *, name: Optional[str] = None,
                 paper_set: bool = False, override: bool = False):
        """Class decorator registering a ``Technique`` subclass.

        Usable bare (``@registry.register``) or with options
        (``@registry.register(paper_set=True)``).  The technique name
        defaults to ``cls.spec.name``.
        """

        def _register(c):
            meta = getattr(c, "spec", None)
            if not isinstance(meta, TechniqueSpec):
                raise TypeError(
                    f"{c.__name__} must define a class-level `spec: "
                    f"TechniqueSpec` to be registered")
            key = _canon(name or meta.name)
            if key in self._entries and not override:
                raise ValueError(
                    f"technique {key!r} already registered "
                    f"({self._entries[key].cls.__name__}); "
                    f"pass override=True to replace it")
            self._entries[key] = TechniqueEntry(
                name=key, cls=c, meta=meta, paper_set=paper_set)
            return c

        return _register(cls) if cls is not None else _register

    def bind_graph_form(self, name: str, *,
                        builder: Optional[Callable] = None,
                        next_size: Optional[Callable] = None,
                        batched: bool = False,
                        max_chunks: Optional[Callable] = None,
                        step: Optional[Any] = None) -> None:
        """Attach/replace the in-graph form for a registered name.

        A plan form (``builder`` or ``next_size``) makes the technique
        plannable via ``jax_sched.plan_chunks``; a step-only form
        (``step`` alone) makes it runnable by the campaign engine
        (``graph_sim.simulate_batch_graph``) without becoming plannable.
        """
        if builder is None and next_size is None and step is None:
            raise ValueError(
                "bind_graph_form needs builder, next_size, or step")
        self[name].graph = GraphForm(builder=builder, next_size=next_size,
                                     batched=batched, max_chunks=max_chunks,
                                     step=step)

    def bind_graph_step(self, name: str, step: Any, *,
                        max_chunks: Optional[Callable] = None) -> None:
        """Attach/merge the *campaign* (``lax.scan``) form without
        clobbering an existing plan form — WF2 keeps its ``next_size``
        planner while also gaining a campaign step.  ``max_chunks``
        replaces the padding bound when given (the adaptive band needs a
        sound ``ceil(n / chunk_param)``-style bound, not the geometric
        estimate)."""
        entry = self[name]
        prev = entry.graph or GraphForm()
        entry.graph = dataclasses.replace(
            prev, step=step,
            max_chunks=max_chunks if max_chunks is not None else prev.max_chunks)

    def bind_techdef(self, name: str, tdef: TechniqueDef) -> None:
        """Attach the form-generating :class:`TechniqueDef` for a
        registered name (set by the deriving module so consumers — the
        graph campaign engine, docs — can read the single definition)."""
        if not isinstance(tdef, TechniqueDef):
            raise TypeError(f"techdef for {name!r} must be a TechniqueDef, "
                            f"got {type(tdef).__name__}")
        self[name].techdef = tdef

    def bind_step_batch(self, name: str, factory: Callable) -> None:
        """Attach/replace the vectorized lane-parallel (``step_batch``)
        form for a registered name.  ``factory(n, p, chunk_param, kws)``
        must return a machine implementing the ``BatchTechnique``
        protocol (`repro.core.techniques`); the batch engine routes the
        technique through its lockstep band instead of the event oracle
        whenever one is bound (adaptive plugins get the fast path the
        same way the built-in AWF/AF/BOLD family does)."""
        if not callable(factory):
            raise TypeError(f"step_batch factory for {name!r} must be "
                            f"callable, got {type(factory).__name__}")
        self[name].step_batch = factory

    # -- views ---------------------------------------------------------------
    def class_view(self) -> "ClassView":
        return ClassView(self)

    def names_view(self, predicate: Optional[Callable[[TechniqueEntry], bool]]
                   = None) -> "NamesView":
        return NamesView(self, predicate)

    def graph_names(self, *, plannable: bool = False) -> tuple[str, ...]:
        """Techniques with an in-graph form.  ``plannable=True`` keeps
        only those ``jax_sched.plan_chunks`` can schedule up front
        (``builder`` or ``next_size``), excluding campaign step-only
        forms (the adaptive band run by ``graph_sim``)."""
        return tuple(
            n for n, e in self._entries.items()
            if e.graph is not None
            and (not plannable or e.graph.builder is not None
                 or e.graph.next_size is not None))

    def step_batch_names(self) -> tuple[str, ...]:
        """Techniques with a vectorized lane-parallel form (the batch
        engine's lockstep band)."""
        return tuple(n for n, e in self._entries.items()
                     if e.step_batch is not None)

    # -- construction --------------------------------------------------------
    def create(self, spec: "ScheduleSpec | str", n: int, p: int, **kw):
        """Instantiate the host reference technique for ``spec``."""
        s = resolve(spec)
        kw.setdefault("chunk_param", s.chunk_param)
        return self[s.technique].cls(n=n, p=p, **kw)


class ClassView(Mapping):
    """Live ``name -> host class`` view of the registry (the old
    ``TECHNIQUES`` dict, kept as a view so plugins appear automatically)."""

    def __init__(self, registry: TechniqueRegistry) -> None:
        self._reg = registry

    def __getitem__(self, name: str) -> type:
        return self._reg[name].cls

    def __iter__(self) -> Iterator[str]:
        return iter(self._reg)

    def __len__(self) -> int:
        return len(self._reg)

    def __contains__(self, name: object) -> bool:
        return name in self._reg

    def __repr__(self) -> str:
        return f"ClassView({list(self._reg)})"


class NamesView(Sequence):
    """Live tuple-like view of registered names matching a predicate (the
    old ``ADAPTIVE_TECHNIQUES``-style tuples).  Compares equal to any
    sequence with the same elements in the same order."""

    def __init__(self, registry: TechniqueRegistry,
                 predicate: Optional[Callable[[TechniqueEntry], bool]] = None):
        self._reg = registry
        self._pred = predicate or (lambda e: True)

    def _names(self) -> tuple[str, ...]:
        return tuple(n for n in self._reg if self._pred(self._reg[n]))

    def __getitem__(self, i):
        return self._names()[i]

    def __len__(self) -> int:
        return len(self._names())

    def __iter__(self) -> Iterator[str]:
        return iter(self._names())

    def __contains__(self, name: object) -> bool:
        return name in self._names()

    def __eq__(self, other) -> bool:
        try:
            return self._names() == tuple(other)
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self._names())

    def __repr__(self) -> str:
        return f"NamesView{self._names()}"


#: The process-global portfolio every layer resolves against.
REGISTRY = TechniqueRegistry()

#: Module-level aliases for the common plugin idiom
#: (``from repro_torch.core.schedule import register_technique``).
register_technique = REGISTRY.register
bind_graph_form = REGISTRY.bind_graph_form
bind_graph_step = REGISTRY.bind_graph_step
bind_step_batch = REGISTRY.bind_step_batch
bind_techdef = REGISTRY.bind_techdef


_BACKENDS = ("auto", "host", "graph")


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """One fully-specified scheduling choice — the unit every consumer takes.

    Fields mirror the knobs the paper exposes per technique:

      technique    registry name (``"fac2"``, ``"awf_b"``, a plugin name, or
                   the OpenMP aliases ``dynamic``/``guided``)
      chunk_param  OpenMP chunk parameter: exact size for static/ss, lower
                   bound for everything else (paper Sec. 3)
      adapt_every  adaptivity cadence for framework-layer consumers: fold
                   measured telemetry into weights every k-th step (1 ==
                   every step, the paper's AWF cadence)
      backend      planning backend: "host" (reference state machines),
                   "graph" (materialize via jax_sched's jit closed forms —
                   consumed by core.planner.plan_schedule), or "auto"

    Text round-trip (the ``OMP_SCHEDULE`` grammar, extended):

        "fac2"                     -> ScheduleSpec("fac2")
        "fac2,64"                  -> chunk_param=64
        "awf_b,1,adapt=4"          -> adapt_every=4
        "gss,1,backend=graph"      -> backend="graph"
    """

    technique: str
    chunk_param: int = 1
    adapt_every: int = 1
    backend: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "technique", _canon(self.technique))
        object.__setattr__(self, "chunk_param", max(1, int(self.chunk_param)))
        object.__setattr__(self, "adapt_every", max(1, int(self.adapt_every)))
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}")

    # -- parsing / env -------------------------------------------------------
    @classmethod
    def parse(cls, text: "str | ScheduleSpec") -> "ScheduleSpec":
        """Parse ``"technique[,chunk][,key=value...]"`` and validate the
        technique against the registry (KeyError lists valid names)."""
        if isinstance(text, ScheduleSpec):
            return text.validated()
        parts = [p.strip() for p in str(text).split(",") if p.strip()]
        if not parts:
            raise ValueError(f"empty schedule spec {text!r}")
        kw: dict[str, Any] = {"technique": parts[0]}
        positional_ok = True
        for tok in parts[1:]:
            if "=" in tok:
                positional_ok = False
                k, _, v = tok.partition("=")
                k = k.strip().lower()
                if k in ("adapt", "adapt_every"):
                    kw["adapt_every"] = int(v)
                elif k in ("chunk", "chunk_param"):
                    kw["chunk_param"] = int(v)
                elif k == "backend":
                    kw["backend"] = v.strip().lower()
                else:
                    raise ValueError(f"unknown schedule option {k!r} in {text!r}")
            elif positional_ok and "chunk_param" not in kw:
                kw["chunk_param"] = int(tok)
            else:
                raise ValueError(f"unexpected token {tok!r} in {text!r}")
        return cls(**kw).validated()

    @classmethod
    def from_env(cls, default: "str | ScheduleSpec | None" = None,
                 var: str = LB_SCHEDULE_ENV) -> Optional["ScheduleSpec"]:
        """The ``OMP_SCHEDULE`` idiom: read the spec from ``$LB_SCHEDULE``;
        fall back to ``default`` (parsed) or None when unset."""
        text = os.environ.get(var)
        if text:
            return cls.parse(text)
        if default is None:
            return None
        return cls.parse(default) if isinstance(default, str) else default.validated()

    # -- registry ------------------------------------------------------------
    def validated(self) -> "ScheduleSpec":
        """Raise KeyError (listing valid names) if the technique is unknown."""
        REGISTRY[self.technique]
        return self

    @property
    def entry(self) -> TechniqueEntry:
        return REGISTRY[self.technique]

    @property
    def meta(self) -> TechniqueSpec:
        return self.entry.meta

    def make(self, n: int, p: int, **kw):
        """Instantiate the host reference technique for this spec."""
        return REGISTRY.create(self, n=n, p=p, **kw)

    # -- convenience ---------------------------------------------------------
    def with_chunk_param(self, chunk_param: int) -> "ScheduleSpec":
        return dataclasses.replace(self, chunk_param=chunk_param)

    def __str__(self) -> str:
        out = self.technique
        if self.chunk_param != 1:
            out += f",{self.chunk_param}"
        if self.adapt_every != 1:
            out += f",adapt={self.adapt_every}"
        if self.backend != "auto":
            out += f",backend={self.backend}"
        return out


def resolve(spec: "ScheduleSpec | str | None", *,
            default: "ScheduleSpec | str | None" = None,
            env: str = LB_SCHEDULE_ENV,
            chunk_param: Optional[int] = None) -> ScheduleSpec:
    """The single resolution path every consumer funnels through.

    - ``ScheduleSpec`` -> validated as-is;
    - a string -> parsed (``"runtime"`` reads ``$LB_SCHEDULE``, mirroring
      OpenMP's ``schedule(runtime)``);
    - ``None`` -> ``$LB_SCHEDULE`` if set, else ``default``.

    ``chunk_param``, when given (including an explicit 1), overrides the
    resolved spec's — consumers expose it so legacy ``(technique,
    chunk_param)`` call sites keep working.
    """
    if isinstance(spec, ScheduleSpec):
        out = spec.validated()
    elif spec is None or (isinstance(spec, str) and _canon(spec) == "runtime"):
        out = ScheduleSpec.from_env(default=default, var=env)
        if out is None:
            raise ValueError(
                f"schedule(runtime): ${env} is unset and no default given")
    elif isinstance(spec, str):
        out = ScheduleSpec.parse(spec)
    else:
        raise TypeError(f"cannot resolve schedule from {type(spec).__name__}")
    if chunk_param is not None:
        out = out.with_chunk_param(chunk_param)
    return out
