"""Checkpointing with async writes and restart, in the reference's on-disk
format.  Port of ``src/repro/checkpoint/store.py``.

Format: one directory per step containing
    manifest.json      — tree structure, logical shapes/dtypes, step meta,
                         per-leaf checksums
    <leaf-id>.npy      — full logical arrays (npy, on the host)

Leaves are flattened in JAX's order (dict keys sorted, then NamedTuple
fields, then tuple items; ``repro_torch.tree``) and keyed as the
reference's ``_leaf_paths`` keys them, so a checkpoint written by either
package restores in the other.  Only the manifest's ``treedef`` string is
the port's own (``tree.tree_structure``); restore does not read it.

Features: atomic directory commit (tmp + rename), keep-last-k GC, async
background writer (training continues while the previous step persists),
leaves written and read by a pool of threads, checksum validation on
restore, resharding onto a mesh on restore, and `latest_step` discovery
for restart.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..tree import (tree_flatten_with_path, tree_leaves, tree_structure,
                    tree_unflatten)

__all__ = ["CheckpointStore"]

_KEY_FORMAT = {"index": "[{}]", "key": "['{}']", "attr": ".{}"}
#: leaves written or read at once: file I/O and sha256 release the
#: interpreter lock, so a large checkpoint moves at several threads' rate
_IO_THREADS = 8


def _leaf_paths(tree) -> list[tuple[str, Any]]:
    """(key, leaf) in JAX's order, each key as the reference builds it from
    the leaf's ``jax.tree_util`` key path."""
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        key = "/".join(_KEY_FORMAT[kind].format(k) for kind, k in path)
        key = key.replace("[", "").replace("]", "")
        key = key.replace("'", "").replace(".", "_").replace("/", "__")
        out.append((key or "root", leaf))
    return out


def _sha(path: Path) -> str:
    """The manifest's checksum: sha256 of the file, 16 hex digits."""
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            digest.update(chunk)
    return digest.hexdigest()[:16]


def _to_host(x) -> np.ndarray:
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype; keep the "
                            "checkpointed state in float32")
        x = x.detach()
        # a CPU tensor's numpy view would follow later in-place updates
        return x.cpu().numpy() if x.is_cuda else x.numpy().copy()
    return np.asarray(x)


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[dict] = None) -> None:
        """Snapshot to the host on the caller thread, persist (optionally)
        async."""
        host = [(key, _to_host(leaf)) for key, leaf in _leaf_paths(tree)]
        treedef = tree_structure(tree)
        self.wait()
        args = (step, host, treedef, extra or {})
        if self.async_write:
            self._pending = threading.Thread(target=self._write, args=args,
                                             daemon=True)
            self._pending.start()
        else:
            self._write(*args)

    def _write(self, step: int, host, treedef: str, extra: dict) -> None:
        tmp = self.dir / f".tmp-{step}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        def write(item):
            i, (key, leaf) = item
            fname = f"{i:04d}_{key[:80]}.npy"
            np.save(tmp / fname, leaf)
            return dict(file=fname, key=key, shape=list(np.shape(leaf)),
                        dtype=str(leaf.dtype), sha=_sha(tmp / fname))

        with ThreadPoolExecutor(_IO_THREADS) as pool:
            leaves = list(pool.map(write, enumerate(host)))
        manifest = {"step": step, "extra": extra,
                    "treedef": treedef, "leaves": leaves}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- load ---------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest step, counting one whose write is still running (it
        is waited for: a restart right after a save must find it)."""
        self.wait()
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like_tree, shardings=None,
                validate: bool = True):
        """Restore into the structure of ``like_tree``: a tensor leaf of it
        gives the restored tensor its device, any other leaf leaves a numpy
        array.  ``shardings``, a tree of ``sharding.NamedSharding`` shaped
        like ``like_tree`` (``param_shardings``' output), puts each leaf on
        its mesh as a DTensor instead: every rank reads the whole array and
        keeps its own shard, so no data crosses ranks, and the mesh may
        differ from the one that saved (elastic restart)."""
        self.wait()
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())

        def load(leaf_info):
            path = d / leaf_info["file"]
            if validate and _sha(path) != leaf_info["sha"]:
                raise IOError(f"checksum mismatch for {leaf_info['file']}")
            return np.load(path)

        with ThreadPoolExecutor(_IO_THREADS) as pool:
            arrays = list(pool.map(load, manifest["leaves"]))
        likes = [leaf for _, leaf in tree_flatten_with_path(like_tree)]
        if len(likes) != len(arrays):
            raise ValueError(f"checkpoint holds {len(arrays)} leaves, the "
                             f"tree {len(likes)}")
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor
            flat_s = tree_leaves(shardings)
            if len(flat_s) != len(arrays):
                raise ValueError(f"{len(flat_s)} shardings for "
                                 f"{len(arrays)} leaves")
            leaves = [distribute_tensor(torch.from_numpy(a), s.mesh,
                                        s.placements, src_data_rank=None)
                      for a, s in zip(arrays, flat_s)]
        else:
            leaves = [torch.from_numpy(a).to(like.device)
                      if torch.is_tensor(like) else a
                      for a, like in zip(arrays, likes)]
        return tree_unflatten(like_tree, leaves), manifest["extra"]
