"""Elastic worker-set changes: re-plan + ``Technique.inherit`` as a
library path.

A copy of ``src/repro/serve/elastic.py`` for the PyTorch port (NumPy; the
reference module loads JAX through ``repro.core``).

In the reference this is the promotion of ``examples/elastic_restart.py``'s
``elastic_handoff`` demo into the serving layer proper: when a worker
set grows or shrinks mid-stream (a replica is lost or added, a cluster
scales up or down), the remaining work is re-planned over the *new*
worker count and the adaptive techniques carry their learned per-worker
telemetry across the resize instead of restarting cold — AWF slices
survivor telemetry (grown workers get a neutral prior), AF reruns its
warm-up only for added workers, BOLD transfers its global per-iteration
statistics (see ``tests/test_elastic.py`` for the exact contracts).

Two entry points:

  * :func:`resize_scheduler` — the serving-path hook: rebuild a
    :class:`~repro_torch.serve.scheduler.RequestScheduler` over a new worker
    count, moving the live backlog and marking the next admission plan
    to ``inherit`` the old technique's state.  ``ClusterRouter`` uses it
    for replica kill / recover / scale events
    (``serve/cluster.py:ClusterRouter.set_active``).
  * :func:`elastic_handoff` — the standalone re-plan + inherit path on
    the chunk-plan level (no serving state), used by the elastic-restart
    example and the trainer's shrink/grow story.
"""

from __future__ import annotations

import numpy as np

from ..core import make_technique, plan_schedule, replan
from .scheduler import RequestScheduler

__all__ = ["elastic_handoff", "resize_scheduler", "neutralize_worker_state"]


def neutralize_worker_state(tech, workers) -> bool:
    """Reset the adaptive per-worker state of ``workers`` to a neutral
    prior, in place — the circuit-breaker rejoin hook.

    A replica rejoining after quarantine inherits the node technique's
    state (``set_active`` → ``Technique.inherit``), including the
    telemetry that described its *degraded* self — without this the
    healed replica keeps a starved weight indefinitely.  Mirrors the
    grow-path of AWF's ``inherit``: the worker's weighted-average-
    performance ratio becomes the mean of the other workers' (den 1.0),
    its telemetry window zeroes, and its raw weight becomes the mean of
    the others' before the usual sum-to-p renormalization.  Attributes
    are ``getattr``-guarded so non-adaptive techniques are a no-op;
    returns whether any state changed.
    """
    p = int(getattr(tech, "p", 0))
    picked = sorted({int(i) for i in workers if 0 <= int(i) < p})
    if not picked:
        return False
    chosen = {i: True for i in picked}
    changed = False
    num = getattr(tech, "_wap_num", None)
    den = getattr(tech, "_wap_den", None)
    if num is not None and den is not None:
        num = np.asarray(num, dtype=np.float64).copy()
        den = np.asarray(den, dtype=np.float64).copy()
        others = [j for j in range(p) if j not in chosen and den[j] > 0.0]
        if others:
            prior = float(np.mean(np.asarray(
                [num[j] / den[j] for j in others])))
            for i in picked:
                num[i] = prior
                den[i] = 1.0
        else:
            for i in picked:
                num[i] = 0.0
                den[i] = 0.0
        tech._wap_num = num
        tech._wap_den = den
        changed = True
    for name in ("_sum_time", "_sum_size"):
        arr = getattr(tech, name, None)
        if arr is not None:
            a = np.asarray(arr).copy()
            for i in picked:
                a[i] = 0
            setattr(tech, name, a)
            changed = True
    w = getattr(tech, "weights", None)
    if w is not None:
        w = np.asarray(w, dtype=np.float64).copy()
        others = [j for j in range(p) if j not in chosen]
        neutral = float(np.mean(w[others])) if others else 1.0
        for i in picked:
            w[i] = neutral
        total = float(np.sum(w))
        if total > 0.0:
            tech.weights = p * w / total
        changed = True
    return changed


def resize_scheduler(sched: RequestScheduler,
                     num_workers: int) -> RequestScheduler:
    """Grow or shrink a live ``RequestScheduler`` to ``num_workers``.

    Returns a *new* scheduler over the same backlog: the unserved
    requests move wholesale (arrival order preserved), and the next
    admission plan is built over the new worker count with
    ``new_tech.inherit(old_tech)`` — the same forced re-plan-with-
    inherited-state the scheduler already performs at every plan
    boundary, only triggered by the worker-set change instead of plan
    exhaustion.  With ``num_workers == sched.num_workers`` the handoff
    is byte-identical: the inherited technique state is an exact copy
    (the equal-p contract of ``Technique.inherit``).

    Grants outstanding at resize time are dropped from telemetry — the
    workers they were measured against may no longer exist, and a
    measurement attributed to a renumbered worker would corrupt the
    inherited weights.  Late ``complete()`` calls against the *old*
    scheduler are harmless no-ops for the new one.
    """
    if num_workers <= 0:
        raise ValueError(f"need num_workers > 0, got {num_workers}")
    new = RequestScheduler(num_workers=num_workers, technique=sched.spec)
    new._pending = sched._pending[sched._head:]
    new._head = 0
    new._plan_gen = sched._plan_gen
    if sched._tech is not None:
        # the next pull re-plans over the moved backlog and inherits the
        # old technique's adaptive state across the p change
        new._tech = sched._tech
        new._force_replan = True
    return new


def elastic_handoff(n: int = 1000, old_p: int = 4, new_p: int = 3,
                    technique: str = "awf_b", chunks_done: int = 10):
    """Re-plan ``n`` iterations from ``old_p`` onto ``new_p`` workers.

    Returns ``(new_plan, old_tech, new_tech)``: the re-balanced
    :class:`~repro_torch.core.planner.Plan` over the surviving workers, and the
    adaptive technique pair after ``new_tech.inherit(old_tech)`` — the
    learned per-worker weights/telemetry of the workers that survive the
    resize carry over instead of restarting cold (new workers, on grow,
    start from a neutral prior).
    """
    # the chunk-plan view: re-balance the remaining iterations
    plan = plan_schedule("fac2", n=n, p=old_p)
    # integer chunk sizes: order-exact  # lint: disable=DET004
    done = sum(c.size for c in plan.chunks[:chunks_done])
    # note: replan shifts chunk starts by `done` (they index the original
    # iteration space), so conservation is checked on sizes, not validate()
    new_plan = replan(plan, new_p=new_p, done_iterations=done)
    # integer chunk sizes: order-exact  # lint: disable=DET004
    assert sum(c.size for c in new_plan.chunks) == n - done

    # the adaptive-state view: run the old technique for a few grants so
    # it learns per-worker speeds, then hand its state to the resized one
    old = make_technique(technique, n=n, p=old_p)
    old.begin_instance(0)
    speeds = 1.0 + 0.5 * np.arange(old_p)  # worker w takes 1 + w/2 ms/iter
    for i in range(4 * old_p):
        w = i % old_p
        g = old.next_chunk(w)
        if g is None:
            break
        old.complete_chunk(w, g, exec_time=g.size * speeds[w] * 1e-3,
                           sched_time=1e-6)
    new = make_technique(technique, n=n - done, p=new_p)
    new.inherit(old)
    new.begin_instance(1)
    return new_plan, old, new
