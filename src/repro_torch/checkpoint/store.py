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
checksum validation on restore, and `latest_step` discovery for restart.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..tree import tree_flatten_with_path, tree_structure, tree_unflatten

__all__ = ["CheckpointStore"]

_KEY_FORMAT = {"index": "[{}]", "key": "['{}']", "attr": ".{}"}


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
        manifest = {"step": step, "extra": extra,
                    "treedef": treedef, "leaves": []}
        for i, (key, leaf) in enumerate(host):
            fname = f"{i:04d}_{key[:80]}.npy"
            np.save(tmp / fname, leaf)
            digest = hashlib.sha256((tmp / fname).read_bytes()).hexdigest()[:16]
            manifest["leaves"].append(
                dict(file=fname, key=key, shape=list(np.shape(leaf)),
                     dtype=str(leaf.dtype), sha=digest))
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
        array.  ``shardings`` (the reference's resharding on a mesh) waits
        for the sharding slice (ROADMAP.md section 1, item 6)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...) waits for the sharding slice "
                "(ROADMAP.md section 1, item 6); one GPU needs none")
        self.wait()
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        arrays = []
        for leaf_info in manifest["leaves"]:
            raw = (d / leaf_info["file"]).read_bytes()
            if validate:
                digest = hashlib.sha256(raw).hexdigest()[:16]
                if digest != leaf_info["sha"]:
                    raise IOError(
                        f"checksum mismatch for {leaf_info['file']}")
            arrays.append(np.load(d / leaf_info["file"]))
        likes = [leaf for _, leaf in tree_flatten_with_path(like_tree)]
        if len(likes) != len(arrays):
            raise ValueError(f"checkpoint holds {len(arrays)} leaves, the "
                             f"tree {len(likes)}")
        leaves = [torch.from_numpy(a).to(like.device) if torch.is_tensor(like)
                  else a for a, like in zip(arrays, likes)]
        return tree_unflatten(like_tree, leaves), manifest["extra"]
