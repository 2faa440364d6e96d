"""Production mesh construction.  Port of ``src/repro/launch/mesh.py``.

Each mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims over
the default process group, which the caller initialises with one rank
per device of the mesh: 256 for the single-pod 16 x 16 mesh, 512 for
2 x 16 x 16.  Functions, not module-level constants: importing this
module touches no process group.

Without that many devices, ``fake_world`` initialises the default group
on PyTorch's ``fake`` backend (``torch.testing._internal.distributed.
fake_pg.FakeStore``).  That group moves no data: its collectives return
at once and leave every tensor as it was, so a mesh on it serves for
layouts (specs, placements, shard shapes), never for results.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..sharding import DEFAULT_RULES, ShardingRules

__all__ = ["make_production_mesh", "make_host_mesh", "replica_submeshes",
           "production_rules", "fake_world"]


def make_production_mesh(*, multi_pod: bool = False,
                         dm_shape: Optional[tuple[int, int]] = None,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 devices a pod; multi-pod adds a leading pod=2 axis.
    `dm_shape` overrides the (data, model) split; the product must stay
    256.  The default process group must hold one rank per device."""
    d, m = dm_shape or (16, 16)
    if d * m != 256:
        raise ValueError(f"dm_shape {(d, m)} must multiply to 256")
    shape = (2, d, m) if multi_pod else (d, m)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the default process group on the data axis:
    (world size, 1) over ("data", "model")."""
    return init_device_mesh(device_type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


def replica_submeshes(mesh: DeviceMesh, num_replicas: int,
                      axis: str = "data") -> list[DeviceMesh]:
    """Replica = data-parallel submesh — the cluster layer's "node".

    Splits ``mesh`` into ``num_replicas`` contiguous submeshes along
    ``axis`` (each keeps the full model axis), one per serving replica.
    The axis size must divide evenly — replicas are homogeneous in device
    count.  Every rank builds every submesh, so that the process groups of
    each are created in the same order on all ranks.
    """
    if num_replicas <= 0:
        raise ValueError(f"need num_replicas > 0, got {num_replicas}")
    names = mesh.mesh_dim_names
    ax = names.index(axis)
    size = mesh.mesh.shape[ax]
    if size % num_replicas:
        raise ValueError(
            f"mesh axis {axis!r} of size {size} does not split into "
            f"{num_replicas} replicas")
    return [DeviceMesh(mesh.device_type, sub, mesh_dim_names=names)
            for sub in torch.chunk(mesh.mesh, num_replicas, dim=ax)]


def production_rules(mesh: DeviceMesh,
                     overrides: Optional[dict] = None) -> ShardingRules:
    rules = DEFAULT_RULES.with_mesh(mesh)
    # KV caches are sharded along the *sequence* dim on the model axis by
    # default: it works for every kv-head count (incl. MQA) and bounds the
    # per-device cache at S/16.  MHA archs whose kv-heads divide the model
    # axis override this to head-sharding (no softmax-stat collectives).
    rules = rules.replace(seq_cache="model")
    if overrides:
        rules = rules.replace(**overrides)
    return rules


@contextlib.contextmanager
def fake_world(world_size: int):
    """The default process group on the ``fake`` backend for the block's
    duration: ``world_size`` ranks that move no data (module docstring)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
