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

On one GPU `shard_as` returns its input: the model code runs unsharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
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

_ctx = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_ctx, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = current_rules()
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def shard_as(x, *logical: Optional[str]):
    """Constrain ``x`` to the layout its logical axes name.  One GPU holds
    every tensor whole, so this is the identity."""
    return x


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
