"""Multi-pod dry run: run every (arch x shape x mesh) cell's real step on
DTensors over the fake process group.  Port of
``src/repro/launch/dryrun.py``.

The reference lowers and compiles the train / prefill / serve step on the
256- and 512-device production meshes and reads the compiled
executable.  The port runs the same steps eagerly: parameters, optimizer
state, inputs and decode state are ``DTensor``s built ``from_local`` with
a local shard of ``NamedSharding.shard_shape`` on the meta device, placed
by ``param_shardings`` / ``_batch_shardings`` on
``make_production_mesh`` over ``launch.mesh.fake_world`` (256 or 512
ranks that move no data).  Under ``use_rules`` the model's ``shard_as``
annotations redistribute activations (``sharding.shard_as``).  One
dispatch mode (``_Probe``) sees every op on the local shards, once each:

  * ``cost.flops``: per device, from ``torch.utils.flop_counter``'s
    formulas on the local shards (and the kernels' stand-ins' formulas);
  * ``memory``: ``argument_size_in_bytes`` / ``output_size_in_bytes`` are
    the arguments' and outputs' local-shard bytes, exact;
    ``peak_memory_in_bytes`` and ``temp_size_in_bytes`` (peak less the
    arguments) come from a tracker of live local-shard storage in eager
    order, not from a compiler's buffer assignment.  A functional
    collective's wrapper returns its input's storage on a device but a new
    tensor on meta; the tracker counts it as the input's, so a meta run
    and a card run of one program track the same peak;
  * ``collectives``: the functional collectives DTensor issues (kind,
    result bytes, group size) under the reference's ring wire model
    (``wire_bytes``).  They come from DTensor's dispatch, not from a
    compiler's HLO, so they are the port's numbers, not the reference's.

Every layer runs eagerly (a Python loop where the reference scans), so
each op is counted as often as it runs: the reference's two-lowering
extrapolation of a scanned body has no counterpart, ``cost`` and
``collectives`` are full counts and ``extrapolated`` is false.  As in the
reference, memory comes from the run at the production microbatch count
and FLOPs and collectives from a run with one microbatch.

Where a kernel or an op cannot take a layout, the port redistributes to
one it can, and the collective is counted:

  * flash attention above ``flash_threshold`` (``models/attention.py``
    ``_flash_sharded``) runs under ``local_map`` on batch- and
    head-sharded local shards; a sequence shard (the ``seq: model``
    archs: internvl2-1b, musicgen-medium, recurrentgemma-2b) is gathered
    first, since the kernels take no causal offset, and each rank picks
    the kv heads of its own q heads from replicated kv heads (GQA / MQA
    kv heads that do not divide the model axis);
  * the MoE (``models/moe.py`` ``_moe_sharded``, ragged and dense) routes
    and runs its experts under ``local_map``: the tokens of a data
    shard's groups, replicated over ``model``, each rank its own experts
    (the expert weights gathered over ``data``), the combine a partial
    sum reduced once a layer; the router's means a partial sum over the
    batch shards;
  * the sLSTM's time loop runs on each batch shard; mLSTM's gate
    ``log_sigmoid`` per shard (no DTensor strategy for its backward);
  * the embedding lookup, the loss's label pick and the decode KV cache
    write (``index_put_`` on a ``seq_cache`` shard) run under
    ``local_map``, each rank on the rows or slots it holds;
  * every weight's and norm scale's FSDP shard is gathered at use
    (``layers.use_weight``, ``rms_norm``), the heads x head_dim dims are
    laid out as whole heads before a split (``sharding.split_last``),
    the serve step's logits are gathered over the vocab before
    ``argmax`` and the prefill step's over the sequence before its last
    position; a microbatch is a slice of every batch shard;
  * anything else DTensor redistributes by its own strategies, which it
    ranks with its collective cost model: here with every host holding
    ``DEVICES_PER_HOST`` devices whatever the shards' device type, and
    with a layout pair's min-cost path reused across shapes
    (``_planning``).  On meta it moves a shard between dims with its
    all-to-all, as on the card (the ``cpu`` mesh's fallback gathers).

On meta the kernels run shape-only stand-ins on the same local shards
(``kernels/stand_ins.py``: ``flash_meta``, ``expert_matmul_meta``, and
``slstm_scan_meta`` for the sLSTM's loop of small ops), so a meta run
issues the collectives the card's program issues.  On the card the
kernels are ``ctypes`` launches the FLOP counter does not see.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--variant ragged]

Results are cached as JSON per cell under ``dryrun_out/`` at the repo
root.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, SHAPES, get_arch, input_specs, shape_applicable
from ..models import init_decode_state
from ..models.decoder import decode_state_axes, decoder_param_specs
from ..optim.adamw import OptimizerConfig, adamw_init, adamw_state_axes
from ..sharding import (NamedSharding, logical_to_spec, mesh_placements,
                        param_shardings, use_rules)
from ..train.steps import make_prefill_step, make_serve_step, make_train_step
from ..tree import tree_leaves, tree_map
from .mesh import fake_world, make_production_mesh, production_rules

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"

#: functional collective (``torch.ops._c10d_functional``) -> the
#: reference's kind name
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # torch.ops._dtensor
}

#: functional collectives' wrappers that return their input's storage on a
#: device (an ``AsyncCollectiveTensor`` over it, or the input waited on)
#: but a new tensor on meta (their fake kernels' ``empty_like``): the probe
#: counts the meta output as the input's storage
_FUNCOL_IDENTITY = ("_wrap_tensor_autograd", "wait_tensor")


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Modeled per-chip wire bytes of one collective (the reference's ring
    model, ``parse_collectives``; n = group size, M = result bytes):

      all-reduce:        2 * M * (n-1)/n
      all-gather:        M * (n-1)/n
      reduce-scatter:    M * (n-1)              (operand = n*M)
      all-to-all:        M * (n-1)/n
      collective-permute: M
    """
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if kind == "all-gather":
        return nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    if kind == "collective-permute":
        return nbytes
    raise KeyError(kind)


def summarize_collectives(ops) -> dict:
    """The reference's summary of (kind, result bytes, group size)
    records; groups of one rank and empty results are dropped, as
    ``parse_collectives`` drops them."""
    summary: dict = {}
    n_ops = 0
    for kind, nbytes, n in ops:
        if nbytes == 0 or n <= 1:
            continue
        n_ops += 1
        s = summary.setdefault(kind, dict(count=0, result_bytes=0,
                                          wire_bytes=0.0))
        s["count"] += 1
        s["result_bytes"] += nbytes
        s["wire_bytes"] += wire_bytes(kind, nbytes, n)
    return dict(ops=summary,
                total_wire_bytes=sum(s["wire_bytes"]
                                     for s in summary.values()),
                total_result_bytes=sum(s["result_bytes"]
                                       for s in summary.values()),
                n_ops=n_ops)


#: (data, model) mesh split per variant (TP/FSDP ratio, product = 256)
VARIANT_MESH: dict[str, tuple[int, int]] = {
    "tp8": (32, 8),
    "tp4": (64, 4),
    "tp2": (128, 2),
}

#: sharding-rule overrides per variant (merged after cfg overrides)
VARIANT_RULES: dict[str, dict] = {
    # ZeRO-3 axis flip: shard the *output* dim of every weight over
    # (model, data) and leave the d_model dim unsharded, so the weight
    # shards are all-gathered just in time instead of all-reducing the
    # (huge) partial matmul outputs over the data axis.
    "zero3": {
        "embed": None,
        "heads": ("model", "data"),
        "kv_heads": ("model", "data"),
        "mlp": ("model", "data"),
        "vocab": ("model", "data"),
        "expert_mlp": "data",
        "lru": ("model", "data"),
    },
}


def variant_config(cfg, variant: str):
    """Apply named optimization variants ('+'-composable hillclimb knobs)."""
    for v in variant.split("+"):
        if v == "baseline" or not v:
            continue
        elif v == "ragged":
            assert cfg.moe is not None
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, dispatch="ragged"))
        elif v == "remat_dots":
            cfg = dataclasses.replace(cfg, remat="dots")
        elif v == "remat_none":
            cfg = dataclasses.replace(cfg, remat="none")
        elif v == "kv8":
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        elif v == "wgather":
            cfg = dataclasses.replace(cfg, gather_weights=True)
        elif v in VARIANT_RULES or v in VARIANT_MESH:
            pass  # rules/mesh-only variant; handled in run_cell
        else:
            raise KeyError(f"unknown variant {v!r}")
    return cfg


def variant_rules(variant: str) -> dict:
    out: dict = {}
    for v in variant.split("+"):
        out.update(VARIANT_RULES.get(v, {}))
    return out


def variant_mesh(variant: str):
    for v in variant.split("+"):
        if v in VARIANT_MESH:
            return VARIANT_MESH[v]
    return None


# ---------------------------------------------------------------------------
# sharded leaves
# ---------------------------------------------------------------------------


def _batch_shardings(rules, specs: dict) -> dict:
    out = {}
    for name, s in specs.items():
        if name == "prefix_embed":
            logical = ("batch", "seq", "embed_act")
        else:
            logical = ("batch", "seq")
        out[name] = NamedSharding(
            rules.mesh, logical_to_spec(rules, logical, tuple(s.shape)))
    return out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _dtensor(spec: torch.Tensor, sharding: NamedSharding,
             device: torch.device):
    """A DTensor of ``spec``'s shape and dtype laid out by ``sharding``,
    its local shard ``sharding.shard_shape`` on ``device``.  Off meta the
    shard holds zeros: values mean nothing on the fake group, and an
    integer input must stay a valid index."""
    from torch.distributed.tensor import DTensor
    shape = tuple(spec.shape)
    local = (torch.empty if device.type == "meta" else torch.zeros)(
        sharding.shard_shape(shape), dtype=spec.dtype, device=device)
    return DTensor.from_local(
        local, sharding.mesh, mesh_placements(sharding.mesh, sharding.spec),
        run_check=False, shape=shape, stride=_contiguous_stride(shape))


def _place(tree, shardings, device):
    return tree_map(lambda t, sh: _dtensor(t, sh, device), tree, shardings)


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(tree) -> int:
    return sum(_local(t).numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# the probe: FLOPs, live bytes and collectives on the local shards
# ---------------------------------------------------------------------------


class _Probe(TorchDispatchMode):
    """Sees each op once, on the local shards: an op on DTensors is
    deferred to DTensor's dispatch (``NotImplemented``), whose local ops
    and functional collectives then come back here as plain tensors."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.collectives: list[tuple[str, int, int]] = []
        self.live = 0
        self.peak = 0
        self._held: dict[int, int] = {}

    def hold(self, t) -> None:
        """Count ``t``'s storage as live until it is freed."""
        if type(t) is not torch.Tensor:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int, *_base) -> None:
        self.live -= self._held.pop(key, 0)

    def alias(self, t, base) -> None:
        """Count ``t`` as ``base``'s storage: no bytes of its own, and
        ``base``'s storage live (its finalizer holds it) until ``t``'s is
        freed."""
        if type(t) is not torch.Tensor:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        self._held[key] = 0
        weakref.finalize(st, self._free, key, base.untyped_storage())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out      # DTensor's shape propagation, not the step
        packet = func._overloadpacket
        formula = self._flop_registry.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = _FUNCOL_KIND.get(packet.__name__)
            if kind is not None:
                self.collectives.append(
                    (kind, _nbytes(out), _group_size(args)))
            elif packet.__name__ in _FUNCOL_IDENTITY:
                self.alias(out, args[0])
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            self.hold(t)
        return out


def _group_size(args) -> int:
    """Rank count of the group a functional collective names (its last
    string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


# ---------------------------------------------------------------------------
# one step on the mesh
# ---------------------------------------------------------------------------


def _step_fn(cfg, shape, rules, device, num_microbatches: int):
    """(step, arguments) of the cell's step: the arguments as DTensors."""
    param_specs, axes = decoder_param_specs(cfg)
    params = _place(param_specs, param_shardings(rules, param_specs, axes),
                    device)
    ins = input_specs(cfg, shape)
    batch = {k: _dtensor(v, sh, device) for (k, v), sh in
             zip(ins.items(), _batch_shardings(rules, ins).values())}
    if shape.kind == "train":
        opt_specs = adamw_init(param_specs)
        opt = _place(opt_specs, param_shardings(
            rules, opt_specs, adamw_state_axes(axes)), device)
        step = make_train_step(cfg, OptimizerConfig(),
                               num_microbatches=num_microbatches)
        return step, (params, opt, batch)
    if shape.kind == "prefill":
        return make_prefill_step(cfg), (params, batch)
    state_specs = init_decode_state(cfg, shape.global_batch,
                                    max_len=shape.seq_len, spec=True)
    state = _place(state_specs, param_shardings(
        rules, state_specs, decode_state_axes(cfg)), device)
    serve = make_serve_step(cfg)
    return (lambda p, s, t: serve(p, s, t, None)), (params, state,
                                                    batch["tokens"])


def _target(owner, name: str):
    """``owner.name``, which one of ``_planning``'s patches replaces.  A
    torch without it would plan, and so record, a different program, so
    the dry run stops there."""
    try:
        return getattr(owner, name)
    except AttributeError:
        raise RuntimeError(
            f"torch {torch.__version__} has no "
            f"{getattr(owner, '__name__', owner)}.{name}, which the dry "
            f"run's planning patches replace") from None


def _shapeless_cost_plans() -> list:
    """Patches under which DTensor's strategy costing
    (``redistribute_cost``) reuses the min-cost path it found for a pair
    of layouts across tensor shapes, where a layout pair needs its graph
    search (a strided shard or a shard order off the mesh's, as the
    512-rank mesh's three axes give): the cost reads only the path's
    steps (the bytes come from the spec at hand), and evenly divided
    dims, as every cell's are, give the same path at any shape.  Without
    it that search took over 10 minutes a cell.  Other pairs, and the
    redistributions the step then runs, plan as before."""
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._ops import utils as op_utils
    plan = _target(_redistribute, "_gen_transform_infos")
    cost = _target(op_utils, "redistribute_cost")
    default = _target(DTensorSpec, "is_default_device_order")
    strided = _target(_redistribute, "_StridedShard")
    memo: dict = {}
    costing = threading.local()

    def searched(spec) -> bool:
        return (not default(spec.shard_order) or any(
            isinstance(p, strided) for p in spec.placements))

    def shapeless_plan(src, dst, *args, **kwargs):
        if not (getattr(costing, "on", False)
                and (searched(src) or searched(dst))):
            return plan(src, dst, *args, **kwargs)
        key = (src.mesh, src.placements, src.shard_order, dst.placements,
               dst.shard_order, len(src.shape), args,
               tuple(sorted(kwargs.items())))
        if key not in memo:
            memo[key] = plan(src, dst, *args, **kwargs)
        return memo[key]

    def costed(*args, **kwargs):
        costing.on = True
        try:
            return cost(*args, **kwargs)
        finally:
            costing.on = False

    return [(_redistribute, "_gen_transform_infos", plan, shapeless_plan),
            (op_utils, "redistribute_cost", cost, costed)]


def _meta_alltoall() -> list:
    """A patch under which DTensor moves a shard between dims of a meta
    tensor with its all-to-all, as it does on the card: on a ``cpu`` mesh
    it falls back to an all-gather of the whole dim and a chunk (gloo has
    no all-to-all), which would count, and hold, the gathered dim."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types
    inner = _target(placement_types, "shard_dim_alltoall")
    op = _target(torch.ops._dtensor, "shard_dim_alltoall")
    group_name = _target(funcol, "_resolve_group_name")

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if input.device.type != "meta":
            return inner(input, gather_dim, shard_dim, mesh, mesh_dim)
        return op(input, gather_dim, shard_dim,
                  group_name((mesh, mesh_dim)))

    return [(placement_types, "shard_dim_alltoall", inner, alltoall)]


#: GPUs a host holds in the production layout (an HGX H100 node): DTensor
#: prices a mesh axis past them at inter-host bandwidth and latency
DEVICES_PER_HOST = 8


def _host_topology() -> list:
    """A patch under which DTensor's collective cost model takes every mesh
    DEVICES_PER_HOST devices to a host, whatever the local shards' device
    type: otherwise it reads the host's own device count (1 card, or the
    CPU's), and a meta run and a card run of one step would rank the
    candidate strategies differently."""
    from torch.distributed.tensor import _collective_utils
    resources = _target(_collective_utils, "_mesh_resources")
    per_host_of = _target(resources, "num_devices_per_host")
    _target(_collective_utils, "MeshTopoInfo").build_from_mesh.cache_clear()

    def per_host(device_type):
        return DEVICES_PER_HOST

    return [(resources, "num_devices_per_host", per_host_of, per_host)]


@contextlib.contextmanager
def _planning():
    """DTensor's sharding propagation without the probe (the tensors its
    planner splits to reckon shard sizes are not the step's), and its
    strided-shard size function memoized: on the 3-axis mesh the planner
    calls that pure function, which splits an ``arange`` of the dim, some
    10^5 times a cell.  With ``_shapeless_cost_plans``, ``_host_topology``
    and ``_meta_alltoall``; each raises where its target is missing."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    name = "propagate_op_sharding_non_cached"
    inner = _target(ShardingPropagator, name)

    def propagate(self, *args, **kwargs):
        with _disable_current_modes():
            return inner(self, *args, **kwargs)

    strided = _target(placement_types, "_StridedShard")
    size_fn = _target(strided, "local_shard_size_and_offset")
    memo: dict = {}

    def local_size(self, *args, **kwargs):
        key = (self, args, tuple(sorted(kwargs.items())))
        if key not in memo:
            memo[key] = size_fn(self, *args, **kwargs)
        return memo[key]

    patches = [(ShardingPropagator, name, inner, propagate),
               (strided, "local_shard_size_and_offset", size_fn, local_size)]
    patches += _shapeless_cost_plans() + _host_topology() + _meta_alltoall()
    for owner, attr, _, new in patches:
        setattr(owner, attr, new)
    try:
        yield
    finally:
        for owner, attr, old, _ in patches:
            setattr(owner, attr, old)


def run_step(cfg, shape, mesh, rules, *, num_microbatches: int = 1,
             device="meta") -> dict:
    """Run the cell's step once on ``mesh`` with local shards on
    ``device``: seconds, per-device FLOPs, memory and collectives."""
    from torch.distributed.tensor.experimental import implicit_replication
    device = torch.device(device)
    step, args = _step_fn(cfg, shape, rules, device, num_microbatches)
    arg_bytes = _nbytes(args)
    probe = _Probe()
    for t in tree_leaves(args):
        probe.hold(_local(t))
    t0 = time.perf_counter()
    with use_rules(rules), implicit_replication(), _planning(), probe:
        out = step(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    if shape.kind == "train":
        out = out[:2] + (tuple(out[2].values()),)
    memory = dict(
        available=True,
        source="local-shard bytes: arguments and outputs exact, peak and "
               "temp from live storage in eager order",
        argument_size_in_bytes=arg_bytes,
        output_size_in_bytes=_nbytes(out),
        peak_memory_in_bytes=probe.peak,
        temp_size_in_bytes=probe.peak - arg_bytes)
    coll = summarize_collectives(probe.collectives)
    coll["extrapolated"] = False
    return dict(seconds=seconds, flops=probe.flops, memory=memory,
                collectives=coll, outputs=out,
                output_leaves=len(tree_leaves(out)))


@contextlib.contextmanager
def _world(size: int):
    """The fake group of ``size`` ranks, or the default group already
    initialised with that many."""
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"the default group has "
                               f"{dist.get_world_size()} ranks, the mesh "
                               f"needs {size}")
        yield
        return
    with fake_world(size):
        yield


def production_microbatches(cfg, shape, mesh) -> int:
    """The train step's microbatch count, clamped so each microbatch's
    batch still divides the (pod x data) axis."""
    if shape.kind != "train":
        return 1
    names = dict(zip(mesh.mesh_dim_names, mesh.shape))
    data_shards = names.get("data", 1) * names.get("pod", 1)
    mb = cfg.train_microbatches
    while mb > 1 and (shape.global_batch % mb
                      or (shape.global_batch // mb) % data_shards):
        mb //= 2
    return mb


@contextlib.contextmanager
def cell_mesh(cfg, *, multi_pod: bool = False, variant: str = "baseline",
              rules_overrides: Optional[dict] = None, device="meta"):
    """The cell's (mesh, rules) on the fake group (256 ranks, 512 with
    ``multi_pod``), the mesh of ``device``'s type (``cpu`` for meta)."""
    with _world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    dm_shape=variant_mesh(variant),
                                    device_type="cpu" if str(device) ==
                                    "meta" else torch.device(device).type)
        merged = dict(cfg.sharding_overrides)
        merged.update(variant_rules(variant))
        if rules_overrides:
            merged.update(rules_overrides)
        yield mesh, production_rules(mesh, merged or None)


def measure(cfg, shape, *, multi_pod: bool = False,
            variant: str = "baseline", rules_overrides: Optional[dict] = None,
            device="meta") -> dict:
    """Run the cell's step on its mesh: memory at the production
    microbatch count, FLOPs and collectives at one microbatch (the
    production run's under ``production``)."""
    with cell_mesh(cfg, multi_pod=multi_pod, variant=variant,
                   rules_overrides=rules_overrides, device=device) as (
                       mesh, rules):
        mb = production_microbatches(cfg, shape, mesh)
        prod = run_step(cfg, shape, mesh, rules, num_microbatches=mb,
                        device=device)
        cost = prod if mb == 1 else run_step(cfg, shape, mesh, rules,
                                             device=device)
        return dict(chips=math.prod(mesh.shape), microbatches=mb,
                    seconds=prod["seconds"], memory=prod["memory"],
                    output_leaves=prod["output_leaves"],
                    flops=cost["flops"], collectives=cost["collectives"],
                    production=dict(flops=prod["flops"],
                                    collectives=prod["collectives"]))


def static_record(arch: str, shape_name: str, *, multi_pod: bool = False,
                  variant: str = "baseline") -> dict:
    """The record's fields that need no run: the cell, its model's counts,
    the chips of its mesh, and ``status: "skipped"`` with the reason where
    the shape does not apply."""
    cfg = variant_config(get_arch(arch), variant)
    shape = SHAPES[shape_name]
    record: dict = dict(arch=arch, shape=shape_name,
                        mesh="pod2" if multi_pod else "pod1",
                        variant=variant,
                        params=cfg.param_count(),
                        active_params=cfg.active_param_count(),
                        tokens=shape.tokens, kind=shape.kind)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=reason)
    else:
        d, m = variant_mesh(variant) or (16, 16)
        record.update(chips=(2 if multi_pod else 1) * d * m)
    return record


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             variant: str = "baseline", rules_overrides: dict | None = None,
             save: bool = True, force: bool = False) -> dict:
    cfg = variant_config(get_arch(arch), variant)
    shape = SHAPES[shape_name]
    mesh_tag = "pod2" if multi_pod else "pod1"
    tag = f"{arch}__{shape_name}__{mesh_tag}__{variant}"
    out_path = RESULTS_DIR / f"{tag}.json"
    if save and out_path.exists() and not force:
        return json.loads(out_path.read_text())

    record = static_record(arch, shape_name, multi_pod=multi_pod,
                           variant=variant)
    if record.get("status") == "skipped":
        if save:
            RESULTS_DIR.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(record, indent=1))
        return record

    t0 = time.time()
    try:
        m = measure(cfg, shape, multi_pod=multi_pod, variant=variant,
                    rules_overrides=rules_overrides)
        record.update(
            status="ok",
            compile_s=round(m["seconds"], 1),
            total_s=round(time.time() - t0, 1),
            microbatches=m["microbatches"],
            cost=dict(flops=float(m["flops"])),
            memory=m["memory"],
            collectives=m["collectives"],
        )
    except Exception as e:  # record failures — they are bugs to fix
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-4000:])
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(record, indent=1))
    return record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                r = run_cell(arch, shape, multi_pod=mp,
                             variant=args.variant, force=args.force)
                stat = r["status"]
                n_ok += stat == "ok"
                n_skip += stat == "skipped"
                n_err += stat == "error"
                extra = ""
                if stat == "ok":
                    mem = r["memory"]
                    tb = mem.get("temp_size_in_bytes", 0)
                    ab = mem.get("argument_size_in_bytes", 0)
                    extra = (f"flops={r['cost'].get('flops', 0):.3g} "
                             f"args={ab/2**30:.2f}GiB temp={tb/2**30:.2f}GiB "
                             f"wire={r['collectives']['total_wire_bytes']/2**30:.3f}GiB "
                             f"compile={r['compile_s']}s")
                elif stat == "error":
                    extra = r["error"][:200]
                print(f"[{stat:7s}] {arch} x {shape} x "
                      f"{'pod2' if mp else 'pod1'} {extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} error={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
