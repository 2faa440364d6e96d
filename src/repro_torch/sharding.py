"""Logical-axis sharding rules, ported from ``src/repro/sharding.py``.

Params and activations are annotated with *logical* axis names at every
call site, as in the reference, and a `ShardingRules` table maps them to
the axes of a ``torch.distributed`` ``DeviceMesh`` (named by its
``mesh_dim_names``):

  * ``logical_to_spec`` resolves names to a spec, one entry per tensor dim:
    a mesh-axis name, a tuple of them, or ``None``; the reference's
    ``PartitionSpec`` as a plain tuple, with its rules (absent mesh axes
    dropped, no mesh axis twice, a dim its axes do not divide replicated,
    trailing ``None``s stripped);
  * ``param_shardings`` gives a tree of `NamedSharding` (mesh + spec) for a
    tree of tensors and its axes tree of `Ax` leaves;
  * ``NamedSharding.placements`` turns the spec into DTensor placements,
    ``Shard(dim)`` or ``Replicate()`` per mesh dim.  A tuple entry shards
    one tensor dim over several mesh dims, major to minor, which is
    DTensor's order only when the tuple follows the mesh's own order, as
    ``DEFAULT_RULES``' ``("pod", "data")`` does; another order raises.

Without a mesh `shard_as` returns its input: the model code runs
unsharded on one GPU.  Under ``use_rules`` with a mesh it redistributes a
``DTensor`` to the layout its logical axes name (``launch/dryrun.py`` runs
the steps so); any other tensor passes through.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional, Sequence

from .tree import tree_map

__all__ = [
    "Ax",
    "ShardingRules",
    "DEFAULT_RULES",
    "NamedSharding",
    "use_rules",
    "current_rules",
    "shard_as",
    "logical_to_spec",
    "param_shardings",
    "mesh_placements",
    "is_dtensor",
    "split_last",
    "merge_last",
    "pointwise",
]


class Ax:
    """Leaf wrapper for a tuple of logical axis names; an axes tree mirrors
    a param tree with Ax leaves."""

    __slots__ = ("names",)

    def __init__(self, *names: Optional[str]):
        self.names = tuple(names)

    def __repr__(self):
        return f"Ax{self.names}"

    def __eq__(self, other):
        return isinstance(other, Ax) and self.names == other.names

    def __hash__(self):
        return hash(self.names)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis -> mesh axis (or tuple of mesh axes, or None)."""

    rules: tuple[tuple[str, object], ...]
    mesh: Any = None      # a torch.distributed DeviceMesh with named dims

    def lookup(self, name: str):
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def replace(self, **updates) -> "ShardingRules":
        new = dict(self.rules)
        new.update(updates)
        return ShardingRules(rules=tuple(new.items()), mesh=self.mesh)

    def with_mesh(self, mesh) -> "ShardingRules":
        return dataclasses.replace(self, mesh=mesh)


# Baseline rules for the (pod, data, model) production mesh.  The single-pod
# mesh has no 'pod' axis; logical_to_spec drops absent axes.
DEFAULT_RULES = ShardingRules(rules=(
    ("batch", ("pod", "data")),
    ("seq", None),
    ("embed", "data"),        # FSDP param shard of d_model dims
    ("embed_act", None),      # activation d_model replicated across model
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("mlp", "model"),
    ("experts", "model"),
    ("moe_group", ("pod", "data")),
    ("expert_mlp", None),
    ("vocab", "model"),
    ("lru", "model"),
    ("conv", None),
    ("capacity", None),
    ("capacity_shard", "model"),
    ("stack", None),          # stacked layer dim
))

# the rules in use, for the whole process: a CUDA backward runs on the
# autograd engine's device thread, whose recomputed forward (remat) must
# see the rules its forward saw (the reference keeps them per thread)
_active: list = [None]


def current_rules() -> Optional[ShardingRules]:
    return _active[0]


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = current_rules()
    _active[0] = rules
    try:
        yield rules
    finally:
        _active[0] = prev


def is_dtensor(x) -> bool:
    """Is ``x`` a ``DTensor``?  (False without importing DTensor when no
    mesh is in use.)"""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_as(x, *logical: Optional[str], shape=None):
    """Constrain ``x`` to the layout its logical axes name: under rules
    with a mesh, a ``DTensor`` is redistributed to the placements of
    ``logical_to_spec`` (a partial sum is reduced on the way); in every
    other case ``x`` is returned as it is, so one GPU runs unsharded.
    ``shape`` (default ``x.shape``) is what divisibility is reckoned on:
    for a flat heads x head_dim dim about to be split, its heads count,
    so that the split finds whole heads on every shard."""
    if not is_dtensor(x):
        return x
    rules = current_rules()
    spec = logical_to_spec(rules, logical,
                           tuple(x.shape if shape is None else shape))
    placements = mesh_placements(rules.mesh, spec)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(rules.mesh, placements)


def _mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(axes: dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(_axis_size(axes, a) for a in axis)
    return axes.get(axis, 1)


def logical_to_spec(rules: ShardingRules, logical: Sequence[Optional[str]],
                    shape: Optional[Sequence[int]] = None) -> tuple:
    """Resolve logical axis names to a spec (a tuple, one entry per dim up
    to the last sharded one).  If `shape` is given, dims not divisible by
    their mesh-axis size are replicated instead."""
    axes = None if rules.mesh is None else _mesh_axes(rules.mesh)
    out: list = []
    used: set = set()
    for i, name in enumerate(logical):
        axis = rules.lookup(name) if name else None
        if axis is None:
            out.append(None)
            continue
        # drop mesh axes that don't exist in the current mesh
        if isinstance(axis, (tuple, list)):
            axis = tuple(a for a in axis if axes is None or a in axes) or None
            if axis is not None and len(axis) == 1:
                axis = axis[0]
        elif axes is not None and axis not in axes:
            axis = None
        if axis is None:
            out.append(None)
            continue
        # no mesh axis may appear twice in one spec
        key = axis if isinstance(axis, tuple) else (axis,)
        if used & set(key):
            out.append(None)
            continue
        if shape is not None and axes is not None:
            if shape[i] % _axis_size(axes, axis) != 0:
                out.append(None)
                continue
        used |= set(key)
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``.  Not a tree
    node, so a tree of them mirrors a tree of tensors."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim in mesh order."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.mesh_dim_names)
        out: list = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            group = entry if isinstance(entry, tuple) else (entry,)
            ranks = [names.index(a) for a in group if a is not None]
            if ranks != sorted(ranks):
                raise ValueError(
                    f"spec entry {entry!r} shards dim {dim} over mesh axes "
                    f"out of the mesh's order {tuple(names)}; DTensor's "
                    "Shard placements cannot express it")
            for r in ranks:
                out[r] = Shard(dim)
        return tuple(out)

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of one device's shard of a ``global_shape`` tensor."""
        axes = _mesh_axes(self.mesh)
        out = list(global_shape)
        for dim, entry in enumerate(self.spec):
            size = _axis_size(axes, entry)
            if out[dim] % size:
                raise ValueError(f"dim {dim} of {tuple(global_shape)} does "
                                 f"not divide into {size} shards")
            out[dim] //= size
        return tuple(out)


class _PinGrad:
    """Identity on a DTensor whose backward lays the gradient out as the
    forward's value was (a view's backward cannot split or merge a dim
    that an arbitrary gradient layout shards)."""

    _fn = None

    @classmethod
    def apply(cls, x):
        if cls._fn is None:
            import torch

            class Pin(torch.autograd.Function):
                @staticmethod
                def forward(ctx, t):
                    ctx.layout = (t.device_mesh, tuple(t.placements))
                    return t.view_as(t)

                @staticmethod
                def backward(ctx, g):
                    return g.redistribute(*ctx.layout)

            cls._fn = Pin
        return cls._fn.apply(x)


def split_last(y, n: int, *logical: Optional[str]):
    """``y`` (..., n * m) -> (..., n, m).  Under a mesh ``y`` is first laid
    out as its ``n`` leading parts are (``logical`` names ``y``'s dims, the
    last one for the ``n`` parts), so each shard holds whole parts, and
    the gradient is laid out so again on the way back."""
    shape = (*y.shape[:-1], n, y.shape[-1] // n)
    if not is_dtensor(y):
        return y.reshape(shape)
    y = shard_as(y, *logical, shape=(*y.shape[:-1], n))
    return _PinGrad.apply(y.reshape(shape))


def merge_last(x, *logical: Optional[str]):
    """``x`` (..., n, m) -> (..., n * m), the inverse of ``split_last``:
    under a mesh ``x`` is first laid out with ``m`` whole (``logical``
    names ``x``'s dims but the last)."""
    shape = (*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if not is_dtensor(x):
        return x.reshape(shape)
    x = shard_as(x, *logical, None)
    return _PinGrad.apply(x.reshape(shape))


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; under a mesh it runs on each
    local shard of ``x`` (``local_map``; a partial sum is reduced first),
    for ops DTensor has no strategy for (``log_sigmoid_backward``)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def mesh_placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` with each tuple entry taken in the
    mesh's order: where ``NamedSharding.placements`` refuses a tuple out of
    that order (the dry run's zero3 variant, ``("model", "data")``), this
    gives every device a shard of the same shape; which piece each device
    holds differs, which no per-device count can see."""
    names = list(mesh.mesh_dim_names)
    ordered = []
    for entry in spec:
        if isinstance(entry, tuple):
            entry = tuple(sorted(entry, key=names.index))
        ordered.append(entry)
    return NamedSharding(mesh, tuple(ordered)).placements


def param_shardings(rules: ShardingRules, params, axes):
    """`NamedSharding`s for a tree of tensors given its logical-axes tree
    (Ax leaves)."""
    mesh = rules.mesh
    if mesh is None:
        raise ValueError("param_shardings needs rules with a mesh "
                         "(ShardingRules.with_mesh)")

    def one(p, ax):
        if not isinstance(ax, Ax):
            raise TypeError(f"axes tree leaf must be Ax, got {ax!r}")
        return NamedSharding(mesh, logical_to_spec(rules, ax.names,
                                                   tuple(p.shape)))

    return tree_map(one, params, axes)
