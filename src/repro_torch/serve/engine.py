"""DecodeEngine: continuous-batching decode on top of the model.  Port of
``src/repro/serve/engine.py``.

Binds the DLS RequestScheduler to `models.decode_step`: a fixed pool of
`slots` decodes in lockstep (one batched step); when a slot's request
finishes, the engine pulls a DLS-sized chunk of queued requests (FAC2 by
default) and refills free slots.  A freed slot's caches (KV and recurrent
states) are reset in place to a fresh single-lane state and the new
request's prompt is prefilled token by token through the same step
function.

Differences from the reference, none of which changes an output:
  * eager PyTorch, no ``jit``;
  * the matmul weights that the reference casts at their use (attention,
    FFN and expert stacks, the recurrent mixers' projections) are cast to
    the compute dtype once, at construction — the same values; what the
    reference uses in fp32 (router, router bias, gates, ``r``, ``b``,
    ``lam``, conv taps), embeddings and norms stay as given.  A tree
    that ``prepare_params`` already made is taken as it is, so engines
    built on one such tree share its tensors (``launch.serve.run_cluster``);
  * the decode state is updated in place.
Sampled decoding (``greedy=False``) draws with ``repro_torch.random``,
``jax.random``'s threefry bits on the engine's device: the key of ``seed``,
split once a step as the reference splits it, greedy or not.  The key
stays on the host, so the split is a little numpy work and launches
nothing on the card.
On the card every step is timed with CUDA events (``EngineStats.step_ms``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.metrics import LoopRecorder
from ..core.schedule import resolve
from ..core.torch_sched import kernel_plan_cache_stats, plan_tiles_cached
from ..device import resolve_device
from ..models import decode_step, init_decode_state
from ..models.layers import dtype_of
from ..random import categorical, key, split
from .scheduler import Request, RequestScheduler

__all__ = ["DecodeEngine", "EngineStats", "prepare_params"]

#: the weights the model casts to the compute dtype at use: attention
#: (wq, wk, wv, wo), the FFN and the expert stacks (wi, wg, wo), the mLSTM
#: projections (wq, wk, wv, wo), the sLSTM input projection (w) and the
#: RG-LRU projections (wx, wgate, wo)
_MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "wi", "wg", "w", "wx", "wgate")


@dataclasses.dataclass
class EngineStats:
    completed: int = 0
    steps: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    # requests shed at admission by the deadline-aware policy
    # (DecodeEngine(shed_slo=...)); 0 when shedding is disabled
    shed: int = 0
    # device time of each decode step in ms (CUDA events; the card only)
    step_ms: list = dataclasses.field(default_factory=list)

    @property
    def tok_per_s(self) -> float:
        return self.tokens / max(self.wall_s, 1e-9)


def prepare_params(params, dtype: torch.dtype, device: torch.device):
    """``params`` on ``device``, the matmul weights cast to ``dtype``.

    ``Tensor.to`` returns the tensor itself when its dtype and device
    already match, so a prepared tree passes through unchanged."""
    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v) for v in tree)
        if key in _MATMUL_WEIGHTS:
            return tree.to(device=device, dtype=dtype)
        return tree.to(device)
    return walk(params)


class DecodeEngine:
    def __init__(self, cfg, params, slots: int = 4, max_len: int = 128,
                 technique="fac2", greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 kernel_schedule="fac2", kernel_p: int = 8,
                 kv_block: int = 16, shed_slo: Optional[float] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = prepare_params(params, dtype_of(cfg.compute_dtype),
                                     self.device)
        self.slots = slots
        self.max_len = max_len
        # deadline-aware shedding: with a step budget of
        # shed_slo * healthy_lanes, backlog beyond what healthy capacity
        # can decode inside the budget is shed at refill instead of
        # queueing unbounded; None disables
        self.shed_slo = shed_slo
        self.shed_rids: list[int] = []
        self.sched = RequestScheduler(num_workers=slots, technique=technique)
        # decode-attention KV tile planning: the same
        # plan_tiles_for_kernel path the flash kernels use, driven by the
        # ragged per-lane cache lengths; records land in kernel_recorder
        self.kernel_spec = resolve(kernel_schedule, default="fac2")
        self.kernel_p = kernel_p
        self.kv_block = kv_block
        self.kernel_recorder = LoopRecorder()
        self.state = init_decode_state(cfg, slots, max_len=max_len,
                                       device=self.device)
        self.greedy = greedy
        self.temperature = temperature
        self._rng = key(seed, device="cpu")
        # per-slot run state
        self._queue: list[list[Request]] = [[] for _ in range(slots)]
        self._active: list[Optional[Request]] = [None] * slots
        self._prompt_left: list[list[int]] = [[] for _ in range(slots)]
        self._emitted: list[int] = [0] * slots
        self._outputs: dict[int, list[int]] = {}
        self._tokens = np.zeros((slots, 1), np.int32)
        self._used = [False] * slots
        # what a reused lane is reset to: recurrent states do not start at
        # zero (the mLSTM / sLSTM stabiliser m starts at -1e30)
        self._fresh = init_decode_state(cfg, 1, max_len=max_len,
                                        device=self.device)
        # decode steps spent on the slot's current admission chunk — the
        # throughput measurement fed back to the DLS scheduler
        self._chunk_steps = [0] * slots
        self._chunk_open = [False] * slots
        # plans are (re)computed only on admission change, through the
        # memoized KernelTilePlan cache
        self._active_mask = np.zeros(slots, bool)
        self._disabled = [False] * slots  # lanes out of service (faults)
        self._need_refill = True
        self.plan_calls = 0          # admissions that planned
        self.plan_time_s = 0.0       # host time spent planning
        self.plan_cache_hits = 0     # plans served from the memo cache

    def _reset_lane(self, s: int) -> None:
        """Splice the fresh single-lane state into lane s in place: per-lane
        pos -> 0 (which masks the stale KV entries) and recurrent states
        back to their initial values."""
        fresh = self._fresh
        for caches, f_caches in zip(self.state.group_caches,
                                    fresh.group_caches):
            for t, f in zip(caches, f_caches):
                t[:, s] = f[:, 0]    # stacked (G, b, ...)
        for cache, f_cache in zip(self.state.rem_caches, fresh.rem_caches):
            for t, f in zip(cache, f_cache):
                t[s] = f[0]
        self.state.pos[s] = 0

    # -- public ----------------------------------------------------------------
    def submit(self, req: Request, prompt: Optional[list[int]] = None):
        if prompt is None:
            rng = np.random.default_rng(req.rid)
            prompt = rng.integers(
                2, self.cfg.vocab_size, size=max(1, min(req.prompt_len,
                                                        self.max_len // 2))
            ).tolist()
        req.prompt_tokens = prompt  # type: ignore[attr-defined]
        self.sched.submit(req)

    def set_slot_enabled(self, s: int, enabled: bool) -> None:
        """Fault-injection hook: take decode lane ``s`` out of (or back
        into) service.

        Disabling a lane mid-request requeues its active request and the
        unstarted rest of its admission chunk back to the scheduler; they
        are re-admitted (and re-prefilled from scratch) on another lane,
        served exactly once overall.  The interrupted chunk's step
        measurement is dropped.  Re-enabling makes the lane eligible again
        at the next refill.
        """
        if enabled:
            if self._disabled[s]:
                self._disabled[s] = False
                self._need_refill = True
            return
        if self._disabled[s]:
            return
        self._disabled[s] = True
        req = self._active[s]
        if req is not None:
            self._outputs.pop(req.rid, None)  # restarts clean elsewhere
            self.sched.submit(req)
            self._active[s] = None
            self._active_mask[s] = False
        for q in self._queue[s]:
            self.sched.submit(q)
        self._queue[s] = []
        self._chunk_open[s] = False
        self._chunk_steps[s] = 0
        self.sched._outstanding.pop(s, None)  # drop the open grant too
        self._need_refill = True

    @torch.no_grad()
    def run(self, max_steps: int = 10_000) -> EngineStats:
        stats = EngineStats()
        t0 = time.time()
        self._shed(stats)
        self._refill()
        while self._active_mask.any() or self.sched.backlog:
            if stats.steps >= max_steps:
                break
            if not self._active_mask.any() and all(self._disabled):
                break  # every lane out of service: the backlog must wait
            self._advance(stats)
            if self._need_refill:
                # only when a slot retired: steady-state decode steps
                # skip the admission scan (and any re-planning) entirely
                self._shed(stats)
                self._refill()
        stats.wall_s = time.time() - t0
        return stats

    def output(self, rid: int) -> list[int]:
        return self._outputs.get(rid, [])

    @property
    def kernel_records(self):
        """Kernel-level telemetry: one LoopInstanceRecord per admission
        (decode-attention KV tile plan over the ragged lane lengths)."""
        return self.kernel_recorder.records

    # -- internals ---------------------------------------------------------------
    def _record_kernel_plan(self) -> None:
        """Plan the decode-attention KV scan as kernel tiles.

        Each active lane's valid KV prefix is ragged; the per-lane cost is
        its live KV block count, and the DLS plan models splitting the
        attention grid across ``kernel_p`` workers.  Runs only on
        admission change and goes through the memoized plan cache.
        """
        live = self.state.pos.cpu().numpy()[self._active_mask].astype(
            np.float64)
        if live.size == 0:
            return
        costs = np.maximum(np.ceil(live / self.kv_block), 1.0)
        hits0 = kernel_plan_cache_stats()["hits"]
        t0 = time.perf_counter()
        plan = plan_tiles_cached(costs, p=self.kernel_p,
                                 technique=self.kernel_spec)
        self.plan_time_s += time.perf_counter() - t0
        self.plan_calls += 1
        self.plan_cache_hits += kernel_plan_cache_stats()["hits"] - hits0
        self.kernel_recorder.add(plan.to_record(
            "decode_kv",
            instance=self.kernel_recorder.next_instance("decode_kv")))

    def _shed(self, stats: Optional[EngineStats] = None) -> int:
        """Deadline-aware shedding: drop the backlog tail the healthy
        lanes cannot decode within the ``shed_slo`` step budget.

        The per-request step estimate is prefill (its prompt tokens) +
        decode (its clamped ``max_new_tokens``); requests are admitted in
        arrival order until the summed estimate exceeds
        ``shed_slo x healthy_lanes``, and the rest are shed.
        """
        if self.shed_slo is None:
            return 0
        lanes = sum(1 for s in range(self.slots) if not self._disabled[s])
        budget = float(self.shed_slo) * lanes
        acc = 0.0
        over: dict[int, bool] = {}
        for req in self.sched._pending[self.sched._head:]:
            prompt = getattr(req, "prompt_tokens", None)
            pre = (len(prompt) if prompt is not None
                   else min(req.prompt_len, self.max_len // 2))
            est = pre + min(req.max_new_tokens, self.max_len // 2)
            acc += float(est)
            if acc > budget:
                over[req.rid] = True
        if not over:
            return 0
        dropped = self.sched.drop(lambda r: r.rid in over)
        for req in dropped:
            self.shed_rids.append(req.rid)
        if stats is not None:
            stats.shed += len(dropped)
        return len(dropped)

    def _refill(self):
        admitted = False
        for s in range(self.slots):
            if self._disabled[s]:
                continue
            if self._active[s] is None:
                if not self._queue[s]:
                    if self._chunk_open[s]:
                        self.sched.complete(s, elapsed=float(
                            max(self._chunk_steps[s], 1)))
                        self._chunk_open[s] = False
                    chunk = self.sched.pull(s)
                    if chunk:
                        self._queue[s] = chunk
                        self._chunk_open[s] = True
                        self._chunk_steps[s] = 0
                        admitted = True
                if self._queue[s]:
                    req = self._queue[s].pop(0)
                    if self._used[s]:
                        self._reset_lane(s)
                    self._used[s] = True
                    self._active[s] = req
                    self._active_mask[s] = True
                    self._prompt_left[s] = list(req.prompt_tokens)
                    self._emitted[s] = 0
                    self._outputs[req.rid] = []
                    self._tokens[s, 0] = self._prompt_left[s].pop(0)
        self._need_refill = False
        if admitted:
            # after activation, so the plan sees the admitted lanes too
            self._record_kernel_plan()

    def _advance(self, stats: EngineStats):
        tokens = torch.from_numpy(self._tokens).to(self.device)
        timed = self.device.type == "cuda"
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        self._rng, sub = split(self._rng)
        logits, self.state = decode_step(self.params, self.cfg, self.state,
                                         tokens)
        last = logits[:, -1, :]
        if self.greedy:
            nxt = torch.argmax(last, dim=-1)
        else:
            nxt = categorical(sub, last / self.temperature, axis=-1)
        if timed:
            ev1.record()
        nxt = nxt.cpu().numpy()          # waits for the step
        if timed:
            stats.step_ms.append(ev0.elapsed_time(ev1))
        stats.steps += 1
        for s in range(self.slots):
            req = self._active[s]
            if req is None:
                self._tokens[s, 0] = 0
                continue
            self._chunk_steps[s] += 1
            if self._prompt_left[s]:
                # still prefilling: feed the next prompt token
                self._tokens[s, 0] = self._prompt_left[s].pop(0)
                continue
            tok = int(nxt[s])
            self._outputs[req.rid].append(tok)
            self._emitted[s] += 1
            stats.tokens += 1
            if self._emitted[s] >= min(req.max_new_tokens,
                                       self.max_len // 2):
                stats.completed += 1
                self._active[s] = None
                self._active_mask[s] = False
                self._need_refill = True
                self._tokens[s, 0] = 0
            else:
                self._tokens[s, 0] = tok
