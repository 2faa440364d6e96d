"""Parameter conversion: a JAX parameter pytree, as numpy arrays, -> torch.

The port never imports JAX.  A caller hands over the tree with every leaf
already turned into a numpy array (``np.asarray`` of each JAX leaf) and
gets back a flat ``dict[str, Tensor]`` keyed by the pytree path, e.g.
``{"wi": ..., "wo": ..., "router": ...}`` for ``repro.models.moe.init_moe``
or ``{"layers/0/attn/wq": ...}`` for a nested tree.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax", "flatten_tree"]


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten nested dicts / lists / tuples into ``{"a/b/0": leaf}``."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else k))
    return out


def params_from_jax(tree: Any, *,
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None
                    ) -> dict[str, torch.Tensor]:
    """Convert a pytree of numpy arrays into a flat dict of tensors.

    ``device`` follows :func:`repro_torch.device.resolve_device` (the card
    unless ``"cpu"`` is asked for).  ``dtype`` casts floating leaves only;
    integer leaves keep their type.  bfloat16 leaves (numpy ``ml_dtypes``)
    are carried through float32, which is exact.
    """
    dev = resolve_device(device)
    out: dict[str, torch.Tensor] = {}
    for key, leaf in flatten_tree(tree).items():
        arr = np.asarray(leaf)
        bf16 = arr.dtype.name == "bfloat16"
        if bf16:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, order="C"))   # a writable copy
        if bf16:
            t = t.to(torch.bfloat16)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[key] = t.to(dev)
    return out
