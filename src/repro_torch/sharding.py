"""Logical-axis sharding rules, ported from ``src/repro/sharding.py``.

Params and activations are annotated with *logical* axis names at every
call site, as in the reference, and a `ShardingRules` table maps them to
mesh axes.  On one GPU there is no mesh: `shard_as` returns its input, and
the names are kept so that a multi-GPU slice can bind them to a device
mesh.  ``logical_to_spec`` and ``param_shardings``, which build JAX
``PartitionSpec``s, wait for that slice (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

__all__ = [
    "Ax",
    "ShardingRules",
    "DEFAULT_RULES",
    "use_rules",
    "current_rules",
    "shard_as",
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

    def lookup(self, name: str):
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def replace(self, **updates) -> "ShardingRules":
        new = dict(self.rules)
        new.update(updates)
        return ShardingRules(rules=tuple(new.items()))


# Baseline rules for the (pod, data, model) production mesh.
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
