"""Torch campaign engine for the adaptive scheduling band — the port of
``src/repro/core/graph_sim.py``.

The third execution form derived from each technique's single
:class:`~repro_torch.core.schedule.TechniqueDef` (see ``core/techniques.py``
for the scalar and lockstep forms): the same chunk-calculus callables run
on torch tensors, with dense ``(L, p)`` float64 lane state on an explicit
device (the card unless the caller passes ``"cpu"``) and a Python loop
over chunk rounds where the reference has a jitted ``lax.while_loop``.

:func:`simulate_batch_graph` mirrors :func:`repro_torch.core.simulate_batch`
exactly: same config grid, same dedup of provably-identical grid points,
same per-(config, timestep) ``SimResult`` stream.  Configs the graph band
cannot take — prebuilt host instances, stateful 3-arg perturbs, plugins
without a campaign form, mutex-sync techniques, ``record_chunks`` (chunk
logs are host-side) — fall back to the host batch engine; the ``strict``
knob reports those fallbacks the same way ``simulate_batch``'s does.

Numerical contract (held by ``tests/test_torch_graph_sim.py`` against the
reference's graph form and the port's batch form): every engine
operation reproduces the lockstep band's float64 arithmetic — same
operand order, same host-precomputed cost prefix sums.  Eager torch runs
each operation as its own kernel, so every product is rounded before the
add that follows it (nothing contracts into an FMA; no fused op such as
``addcmul`` is used where the reference rounds twice); the reference's
guard sites keep their names (:func:`_round_mul_add`, ``ops.muladd`` /
``ops.freeze``).  Worker-axis reductions keep the reference's association
order (:func:`_numpy_order_sum`) — ``torch.sum`` reduces in another order
on either device.  Results are bit-exact against the host engines for
p < 8 and within rtol 1e-9 above; BOLD, whose slack term takes a log,
keeps the reference's documented tolerance (the device's ``log`` and
``math.log`` may differ by an ulp, and a flipped chunk ``ceil`` then
shifts a grant).

The round loop reads "is any lane still live" on the host before every
round, as the reference's ``while_loop`` condition does; each read is a
host sync.  ``LAST_RUN`` holds the lanes, groups, rounds and host syncs
of the last call.

On the card the engine is launch-bound: every round is about a hundred
small kernels over ``(L, p)`` lanes, so for now ``simulate_batch`` on
the host is the faster choice (measured on the Table 1 campaign in
``PERF.md``).  This engine is the API mirror of the reference's card
path until a fused or captured round makes it pay off.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .batch_sim import (
    BatchConfig,
    _copy_result,
    _dedup_key,
    _lane_speeds,
    _stateful_perturb,
    simulate_batch,
)
from .metrics import LoopInstanceRecord, LoopRecorder
from .schedule import REGISTRY, ScheduleSpec, TechniqueDef, resolve
from .simulator import (
    EXACT_PROFILE,
    OverheadModel,
    ProfileModel,
    SimResult,
    _technique_kwargs,
)
from .techniques import Technique

__all__ = ["CampaignStep", "bind_campaign_form", "simulate_batch_graph",
           "LAST_RUN"]

_I64, _F64 = torch.int64, torch.float64

#: lanes, groups, rounds and host syncs of the last ``simulate_batch_graph``
LAST_RUN: dict = {}


def _numpy_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over its last axis in the exact association order of
    NumPy's ``pairwise_sum`` as the reference's graph form unrolls it:
    sequential below 8 terms, eight interleaved accumulators combined as
    ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))`` up to 128, recursive halving
    (rounded down to a multiple of 8) above.  The eight accumulators are
    one column block each, so a block of 8 columns is one add."""
    n = x.shape[-1]
    if n < 8:
        acc = x[..., 0]
        for i in range(1, n):
            acc = acc + x[..., i]
        return acc
    if n <= 128:
        r = x[..., :8]
        i = 8
        while i + 8 <= n:
            r = r + x[..., i:i + 8]
            i += 8
        r = r[..., 0::2] + r[..., 1::2]          # r0+r1, r2+r3, r4+r5, r6+r7
        r = r[..., 0::2] + r[..., 1::2]          # (..)+(..), (..)+(..)
        acc = r[..., 0] + r[..., 1]
        for j in range(i, n):
            acc = acc + x[..., j]
        return acc
    n2 = (n // 2) - ((n // 2) % 8)
    return _numpy_order_sum(x[..., :n2]) + _numpy_order_sum(x[..., n2:])


def _round_mul_add(a, b, c):
    """``round(a*b) + c``: the product is rounded before the add.  The
    reference guards this against XLA's FMA contraction; eager torch runs
    the multiply and the add as two kernels, so the two roundings hold by
    construction (never replace this with ``addcmul``)."""
    return a * b + c


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d tensor beside ``like``: float64 for a
    float, int64 for an int (a bare ``torch.as_tensor`` would make a
    float32 and round the constant)."""
    if torch.is_tensor(x):
        return x
    dt = torch.bool if isinstance(x, bool) else (
        _I64 if isinstance(x, (int, np.integer)) else _F64)
    return torch.as_tensor(x, dtype=dt, device=like.device)


class _TorchOps:
    """Ops façade for the torch form: per-worker state is ``(L, p)``
    tensors, per-lane quantities are ``(L,)`` columns, ``worker`` is the
    ``(L,)`` requesting-worker vector.  Scatters are functional (a copy
    with the lane entries replaced) — the TechniqueDef contract (never
    read an entry after scattering into it) makes that equivalent to the
    NumPy in-place scatters of the batch form."""

    def __init__(self, device: torch.device, lanes: int):
        self.device = device
        self.ar = torch.arange(lanes, device=device)

    log = staticmethod(torch.log)
    sqrt = staticmethod(torch.sqrt)
    ceil = staticmethod(torch.ceil)

    @staticmethod
    def where(c, a, b):
        like = next(t for t in (c, a, b) if torch.is_tensor(t))
        return torch.where(_scalar(c, like), _scalar(a, like),
                           _scalar(b, like))

    @staticmethod
    def maximum(a, b):
        like = a if torch.is_tensor(a) else b
        return torch.maximum(_scalar(a, like), _scalar(b, like))

    @staticmethod
    def minimum(a, b):
        like = a if torch.is_tensor(a) else b
        return torch.minimum(_scalar(a, like), _scalar(b, like))

    def f64(self, x):
        if torch.is_tensor(x):
            return x.to(_F64)
        return torch.as_tensor(x, dtype=_F64, device=self.device)

    @staticmethod
    def expand(x):
        return x[..., None]

    @staticmethod
    def muladd(a, b, c):
        return _round_mul_add(a, b, c)

    @staticmethod
    def freeze(x):
        # the reference's opaque copy keeps XLA from contracting a product
        # into a downstream add; an eager product is already rounded
        return x

    @staticmethod
    def rsum(x):
        return _numpy_order_sum(x)

    @staticmethod
    def rany(x):
        return x.any(dim=-1)

    @staticmethod
    def rall(x):
        return x.all(dim=-1)

    def gather(self, x, worker):
        return x[self.ar, worker]

    def scatter_add(self, x, worker, v):
        x = x.clone()
        x[self.ar, worker] = x[self.ar, worker] + v
        return x

    def scatter_set(self, x, worker, v):
        x = x.clone()
        x[self.ar, worker] = _scalar(v, x).to(x.dtype)
        return x


@dataclasses.dataclass(frozen=True)
class CampaignStep:
    """The object bound as ``GraphForm.step``: ties a registered name to
    the :class:`TechniqueDef` the campaign engine runs.  Presence of a
    ``CampaignStep`` is what makes a technique graph-band eligible."""

    tdef: TechniqueDef


def bind_campaign_form(name: str) -> None:
    """Derive + bind the campaign form for a registered technique that
    carries a :class:`TechniqueDef` — the graph-side counterpart of
    ``techniques._def_technique``.  Also installs the definition's sound
    ``max_chunks`` bound so ``torch_sched``'s padding
    (``max_chunks_bound``) covers the adaptive band."""
    tdef = REGISTRY[name].techdef
    if tdef is None:
        raise KeyError(
            f"bind_campaign_form: technique {name!r} has no TechniqueDef "
            f"(bind one with repro_torch.core.schedule.bind_techdef first)")
    REGISTRY.bind_graph_step(name, CampaignStep(tdef),
                             max_chunks=tdef.max_chunks)


# ---------------------------------------------------------------------------
# The per-(technique, p) engine
# ---------------------------------------------------------------------------


def _fold_gated(state: dict, upd: dict, gate: torch.Tensor) -> dict:
    """Merge a callable's returned entries into the state, lane-gated:
    where ``gate`` is False the old value survives — the equivalent of the
    batch form's active-row fancy indexing."""
    out = dict(state)
    for k, v in upd.items():
        old = state[k]
        v = _scalar(v, old)
        g = gate.reshape(gate.shape + (1,) * max(v.ndim - 1, 0))
        out[k] = torch.where(g, v, old)
    return out


def _run_engine(tdef: TechniqueDef, p: int, use_numa: bool, dev, n, cp,
                offs, csum, cold, sconst, pen, bounds, speeds, tsteps,
                state: dict, stats: dict):
    """One (technique, p) group: mirrors ``batch_sim._run_lockstep_band``
    operation for operation (as the reference's traced engine does): per
    round, pop each lane's (ready, tiebreak)-least worker, compute the
    thresholded chunk size from the TechniqueDef state, clamp, update the
    factoring bookkeeping, charge the atomic-path costs with the oracle's
    float64 operand order, and fold the measurement back — every update
    gated by ``scheduled < n`` so finished lanes coast.  Returns the
    (T, L, p) busy, sched and finish tensors and the (T, L) chunk counts.
    """
    L = n.shape[0]
    T = speeds.shape[0]
    ops = _TorchOps(dev, L)
    arL = ops.ar
    n_f = n.to(_F64)  # the band's tb_base: tiebreak epoch stride
    last = csum.shape[0] - 1

    busy_out, sched_out, fin_out, req_out = [], [], [], []
    for ts in range(T):
        live_ts = tsteps > ts
        # begin_instance: timestep-cadence adapt, then factoring reset
        if tdef.cadence == "timestep" and tdef.adapt is not None:
            state = _fold_gated(state, tdef.adapt(ops, dict(state), p),
                                live_ts)
        if tdef.factoring:
            in_batch = torch.zeros(L, dtype=_I64, device=dev)
            batch_chunk = torch.clamp_min(
                torch.ceil(n_f / (2.0 * p)), 1).to(_I64)
        else:
            in_batch = batch_chunk = torch.zeros(L, dtype=_I64, device=dev)
        # dead lanes (tsteps <= ts) start "finished"
        scheduled = torch.where(live_ts, 0, n)
        reqidx = torch.zeros(L, dtype=_I64, device=dev)
        ready = torch.where(live_ts[:, None],
                            torch.zeros((L, p), dtype=_F64, device=dev),
                            torch.inf)
        tb = torch.arange(p, dtype=_F64, device=dev).repeat(L, 1)
        busy = torch.zeros((L, p), dtype=_F64, device=dev)
        sched = torch.zeros((L, p), dtype=_F64, device=dev)
        spd = speeds[ts]
        st = state

        rounds = 0
        while True:
            stats["syncs"] += 1
            if not bool((scheduled < n).any()):
                break
            rounds += 1
            live = scheduled < n
            # heap order: least ready time, least insertion tiebreak
            t = ready.min(dim=1).values
            cand = torch.where(ready == t[:, None], tb, torch.inf)
            w = torch.argmin(cand, dim=1)
            start = scheduled
            rem = n - scheduled
            raw = tdef.chunk_size(ops, dict(st), w, rem.to(_F64), p,
                                  batch_chunk if tdef.factoring else None)
            size = torch.maximum(
                torch.clamp_min(torch.ceil(raw).to(_I64), 1), cp)
            if tdef.warming is not None:
                # warm-up grants bypass the chunk_param threshold
                warm = tdef.warming(ops, dict(st), w)
                size = torch.where(
                    warm, torch.clamp_max(torch.clamp_min(rem, 1),
                                          tdef.warmup_chunk), size)
            size = torch.clamp_min(torch.minimum(size, rem), 1)
            rem_after = rem - size
            # granted: factoring roll + batch-cadence adapt (before
            # complete, exactly like the host forms)
            if tdef.factoring:
                ib = in_batch + 1
                roll = ib >= p
                upd = roll & (rem_after > 0)
                bc_new = torch.where(
                    upd, torch.clamp_min(torch.ceil(
                        rem_after.to(_F64) / (2.0 * p)), 1).to(_I64),
                    batch_chunk)
                in_batch = torch.where(live, torch.where(roll, 0, ib),
                                       in_batch)
                batch_chunk = torch.where(live, bc_new, batch_chunk)
                if tdef.cadence == "batch" and tdef.adapt is not None:
                    st = _fold_gated(st, tdef.adapt(ops, dict(st), p),
                                     roll & live)
            scheduled = torch.where(live, start + size, scheduled)
            reqidx = torch.where(live, reqidx + 1, reqidx)
            # execution cost off the host-precomputed prefix sums; finished
            # lanes read clamped garbage (every use is gated by `live`)
            idx = offs + start
            base = (csum[torch.clamp_max(idx + size, last)]
                    - csum[torch.clamp_max(idx, last)])
            if use_numa:
                hi = start + size
                local = torch.clamp_min(
                    torch.minimum(hi, bounds[arL, w + 1])
                    - torch.maximum(start, bounds[arL, w]), 0)
                base = base * _round_mul_add(
                    pen, 1.0 - local.to(_F64) / size.to(_F64), 1.0)
            e = _round_mul_add(base, spd[arL, w], cold)
            s = sconst
            # complete: fold the measurement, chunk-cadence adapt
            if tdef.on_complete is not None:
                tm = e + s if tdef.include_overhead else e + 0.0
                st = _fold_gated(
                    st, tdef.on_complete(ops, dict(st), w, size, tm, p), live)
                if tdef.cadence == "chunk" and tdef.adapt is not None:
                    st = _fold_gated(st, tdef.adapt(ops, dict(st), p), live)
            done = t + s + e
            livex = live[:, None]
            hit = torch.zeros((L, p), dtype=torch.bool, device=dev)
            hit[arL, w] = True
            hit &= livex
            # ready doubles as the finish log (a worker's clock only ever
            # moves to its chunk completion time)
            ready = torch.where(hit, done[:, None], ready)
            tb = torch.where(hit, (n_f + reqidx)[:, None], tb)
            busy = torch.where(hit, busy + e[:, None], busy)
            sched = torch.where(hit, sched + s[:, None], sched)
        stats["rounds"] += rounds
        state = st
        busy_out.append(busy)
        sched_out.append(sched)
        fin_out.append(ready)
        req_out.append(reqidx)
    return (torch.stack(busy_out), torch.stack(sched_out),
            torch.stack(fin_out), torch.stack(req_out))


# ---------------------------------------------------------------------------
# Campaign entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _GLane:
    """One graph-band config: like the host band's ``_ALane``, a lane
    spans all its timesteps (adaptive state carries across instances)."""

    config_idx: int
    cfg: BatchConfig
    spec: ScheduleSpec
    kw: dict
    overhead: OverheadModel
    tdef: TechniqueDef


def _stack_states(tdef: TechniqueDef, p: int, kws: list) -> dict:
    """Stack per-lane ``init_state`` dicts into dense (L,)/(L, p) arrays
    — the same layout rule as the batch form's ``_init_batch``."""
    states = [tdef.init_state(p, kw) for kw in kws]  # validates kws
    out: dict[str, np.ndarray] = {}
    for k in (tuple(states[0]) if states else ()):
        vals = [s[k] for s in states]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals).astype(np.float64)
        elif isinstance(vals[0], (int, np.integer)):
            out[k] = np.asarray(vals, np.int64)
        else:
            out[k] = np.asarray(vals, np.float64)
    return out


def _note_fallback(strict, reason: str) -> None:
    msg = ("simulate_batch_graph: config falls back to the host batch "
           "engine instead of the torch graph band: " + reason)
    if strict is True:
        raise RuntimeError(msg)
    if strict == "warn":
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _run_group(group: list, p: int, results: list, dev,
               stats: dict) -> None:
    tdef = group[0].tdef
    L = len(group)
    n = np.asarray([gl.cfg.workload.n for gl in group], np.int64)
    cp = np.asarray([gl.spec.chunk_param for gl in group], np.int64)
    tsteps = np.asarray([gl.cfg.timesteps for gl in group], np.int64)
    T = int(tsteps.max())
    if T <= 0:
        for gl in group:
            results[gl.config_idx] = []
        return

    # flat concatenated cost prefix sums (shared per unique workload)
    offs = np.zeros(L, np.int64)
    parts: list[np.ndarray] = []
    seen: dict[int, int] = {}
    total = 0
    for li, gl in enumerate(group):
        wkl = gl.cfg.workload
        coff = seen.get(id(wkl))
        if coff is None:
            csum = np.concatenate([[0.0], np.cumsum(wkl.costs)])
            seen[id(wkl)] = coff = total
            parts.append(csum)
            total += len(csum)
        offs[li] = coff
    csum_flat = np.concatenate(parts)

    cold = np.asarray([gl.cfg.chunk_cold_cost for gl in group], np.float64)
    sconst = np.asarray([
        (gl.overhead.o_dispatch + gl.overhead.sync_cost(gl.spec.meta.sync))
        + gl.overhead.calc_cost(gl.spec.meta.o_cs) for gl in group],
        np.float64)
    pen = np.asarray([gl.cfg.numa_penalty for gl in group], np.float64)
    use_numa = bool((pen > 0.0).any())
    bounds = np.zeros((L, p + 1), np.int64)
    if use_numa:
        for li, gl in enumerate(group):
            bounds[li] = np.linspace(0, gl.cfg.workload.n,
                                     p + 1).astype(np.int64)
    speeds = np.ones((T, L, p))
    for li, gl in enumerate(group):
        for ts in range(gl.cfg.timesteps):
            speeds[ts, li] = _lane_speeds(gl.cfg, ts)
    state = _stack_states(tdef, p, [gl.kw for gl in group])

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    stats["lanes"] += L
    stats["groups"] += 1
    busy, sched, fin, req = _run_engine(
        tdef, p, use_numa, dev, up(n), up(cp), up(offs), up(csum_flat),
        up(cold), up(sconst), up(pen), up(bounds), up(speeds), up(tsteps),
        {k: up(v) for k, v in state.items()}, stats)
    busy, sched = busy.cpu().numpy(), sched.cpu().numpy()
    fin, req = fin.cpu().numpy(), req.cpu().numpy()
    stats["syncs"] += 1          # the group's results back to the host

    for li, gl in enumerate(group):
        cfg, spec = gl.cfg, gl.spec
        out = []
        for ts in range(cfg.timesteps):
            f = fin[ts, li].copy()
            rec = LoopInstanceRecord(
                loop=cfg.workload.name,
                technique=spec.technique,
                instance=ts,
                p=p,
                n=cfg.workload.n,
                chunk_param=spec.chunk_param,
                t_par=float(f.max()),
                thread_times=busy[ts, li] + sched[ts, li],
                thread_finish=f,
                n_chunks=int(req[ts, li]),
                sched_time=float(sched[ts, li].sum()),
                chunks=None,
            )
            out.append(SimResult(record=rec, engine_used="graph"))
        results[gl.config_idx] = out


def simulate_batch_graph(
    configs: Sequence[BatchConfig],
    *,
    overhead: OverheadModel = OverheadModel(),
    profile: ProfileModel = EXACT_PROFILE,
    recorder: Optional[LoopRecorder] = None,
    record_chunks: bool = False,
    strict=False,
    device=None,
) -> list[list[SimResult]]:
    """Simulate a config grid with the torch campaign engine on ``device``
    (the card unless the caller passes ``"cpu"``; asking for the card
    where there is none raises).

    Drop-in for :func:`repro_torch.core.simulate_batch` — same inputs, same
    per-(config, timestep) results — but every adaptive/worker-dependent
    config whose technique carries a campaign graph form (the generated
    AWF/AF/mAF/BOLD/WF2 family and any plugin bound via
    :func:`bind_campaign_form`) runs as dense ``(L, p)`` float64 tensors,
    one lane group per (technique, p).  Everything else falls back to the
    host batch engine: non-adaptive configs to its (already vectorized)
    plan band silently, and graph-*ineligible* adaptive configs —
    prebuilt host instances, 3-arg stateful perturbs, plugins without a
    campaign form, mutex-sync techniques, or ``record_chunks=True`` (chunk
    logs are host-side) — reported via ``strict`` (``False`` silent /
    ``"warn"`` / ``True`` raises), the same knob ``simulate_batch`` itself
    takes.  On the card, ``simulate_batch`` is for now the faster choice
    (see the module docstring).

    Results are tagged ``engine_used="graph"`` on the graph band; see
    the module docstring for the numerical contract vs the host forms.
    """
    if strict not in (False, "warn", True):
        raise ValueError(
            f"strict must be False, 'warn', or True, got {strict!r}")
    dev = resolve_device(device)
    stats = dict(device=str(dev), lanes=0, groups=0, rounds=0, syncs=0)
    LAST_RUN.clear()
    LAST_RUN.update(stats)
    if record_chunks:
        _note_fallback(strict, "record_chunks=True needs host-side chunk "
                       "grant logs")
        return simulate_batch(configs, overhead=overhead, profile=profile,
                              recorder=recorder, record_chunks=True)

    results: list[Optional[list[SimResult]]] = [None] * len(configs)
    glanes: list[_GLane] = []
    host_idx: list[int] = []
    memo: dict = {}
    aliases: dict[int, int] = {}

    for ci, cfg in enumerate(configs):
        ov = cfg.overhead if cfg.overhead is not None else overhead
        prof = cfg.profile if cfg.profile is not None else profile
        reason = None
        eligible = False
        if isinstance(cfg.technique, Technique):
            reason = ("prebuilt Technique instance (host state machines "
                      "cannot run on the graph band)")
        else:
            spec = resolve(cfg.technique, chunk_param=cfg.chunk_param)
            if cfg.workload.n <= 0 or cfg.p <= 0:
                raise ValueError(
                    f"need n>0, p>0, got n={cfg.workload.n} p={cfg.p}")
            meta = spec.meta
            gf = spec.entry.graph
            step = gf.step if gf is not None else None
            tdef = step.tdef if isinstance(step, CampaignStep) else None
            if not (meta.adaptive
                    or getattr(meta, "worker_dependent", False)):
                pass  # plan band: vectorized host path, intentional
            elif _stateful_perturb(cfg.perturb):
                reason = ("3-arg stateful perturb callback (per-chunk rng "
                          "draws must replay in event order)")
            elif tdef is None:
                reason = (f"technique {spec.technique!r} has no campaign "
                          f"graph form (bind one with "
                          f"repro_torch.core.graph_sim.bind_campaign_form)")
            elif meta.sync == "mutex":
                reason = (f"technique {spec.technique!r} uses mutex sync "
                          f"(the graph band models the atomic path)")
            else:
                eligible = True
        if not eligible:
            if reason is not None and strict is not False:
                _note_fallback(strict, reason)
            host_idx.append(ci)
            continue
        key = _dedup_key(cfg, spec, ov, prof)
        if key is not None:
            prev = memo.setdefault(key, ci)
            if prev != ci:
                aliases[ci] = prev
                continue
        kw = _technique_kwargs(spec, cfg.workload, cfg.p, ov, cfg.weights,
                               prof, seed=cfg.seed)
        glanes.append(_GLane(config_idx=ci, cfg=cfg, spec=spec, kw=kw,
                             overhead=ov, tdef=tdef))

    if host_idx:
        sub = simulate_batch([configs[i] for i in host_idx],
                             overhead=overhead, profile=profile)
        for i, res in zip(host_idx, sub):
            results[i] = res

    groups: dict[tuple[str, int], list[_GLane]] = {}
    for gl in glanes:
        groups.setdefault((gl.spec.technique, gl.cfg.p), []).append(gl)
    for (_, p), group in groups.items():
        _run_group(group, p, results, dev, stats)
    LAST_RUN.update(stats)

    for ci, prev in aliases.items():
        results[ci] = [_copy_result(r) for r in results[prev]]

    if recorder is not None:
        # one record per (config, timestep), in config order
        for per_config in results:
            for res in per_config:
                recorder.add(res.record)
    return results  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Bind the campaign forms for every TechniqueDef-generated technique
# ---------------------------------------------------------------------------

for _name in list(REGISTRY):
    if REGISTRY[_name].techdef is not None:
        bind_campaign_form(_name)
del _name
