"""Conversion from the JAX reference's trees to the port's tensors.

The port never imports JAX.  A caller hands over a tree whose leaves are
arrays numpy can read (``np.asarray`` of each leaf; JAX arrays qualify):

  * ``params_from_jax``: any parameter tree -> a flat ``dict[str, Tensor]``
    keyed by the pytree path, e.g. ``{"wi": ..., "wo": ..., "router": ...}``
    for ``repro.models.moe.init_moe``;
  * ``decoder_params_from_jax``: ``repro.models.init_decoder``'s tree
    (nested dicts, the stacked ``groups`` and the ``remainder`` tuples) ->
    the same nesting of tensors, the port decoder's parameters: attention
    and MLP weights, the MoE router and expert stacks, the recurrent
    mixers' leaves;
  * ``decode_state_from_jax``: a reference ``DecodeState`` -> the port's,
    KV caches and recurrent states alike;
  * ``adamw_state_from_jax``: a reference ``AdamWState`` (step, mu, nu) ->
    the port's, the moments nested as ``decoder_params_from_jax`` nests
    parameters;
  * ``key_from_jax``: ``jax.random.key_data`` of a key -> the port's key
    (``repro_torch.random``), so both packages draw from one key.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .device import resolve_device
from .models.attention import KVCache, KVCacheQ
from .models.decoder import DecodeState, tree_map
from .models.recurrent import MLSTMState, RGLRUState, SLSTMState
from .optim.adamw import AdamWState

__all__ = ["params_from_jax", "flatten_tree", "decoder_params_from_jax",
           "decode_state_from_jax", "adamw_state_from_jax", "key_from_jax"]


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
    return {key: _tensor(leaf, dev, dtype)
            for key, leaf in flatten_tree(tree).items()}


def _tensor(leaf, dev: torch.device,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    arr = np.asarray(leaf)
    bf16 = arr.dtype.name == "bfloat16"
    if bf16:
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, order="C"))   # a writable copy
    if bf16:
        t = t.to(torch.bfloat16)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(dev)


def decoder_params_from_jax(tree: Any, *,
                            device: Optional[Union[str, torch.device]] = None,
                            dtype: Optional[torch.dtype] = None) -> Any:
    """``repro.models.init_decoder``'s parameter tree -> the port decoder's
    (the same nesting, tensors at the leaves).  ``device`` and ``dtype`` as
    in :func:`params_from_jax`."""
    dev = resolve_device(device)
    return tree_map(lambda leaf: _tensor(leaf, dev, dtype), tree)


def decode_state_from_jax(state: Any, *,
                          device: Optional[Union[str, torch.device]] = None):
    """A reference ``DecodeState`` (KVCache / KVCacheQ / MLSTMState /
    SLSTMState / RGLRUState leaves) -> the port's, field by field."""
    dev = resolve_device(device)
    classes = {cls.__name__: cls for cls in (KVCache, KVCacheQ, MLSTMState,
                                             SLSTMState, RGLRUState)}

    def cache(c):
        cls = classes[type(c).__name__]
        return cls(*(_tensor(getattr(c, f), dev) for f in cls._fields))

    return DecodeState(
        group_caches=tuple(cache(c) for c in state.group_caches),
        rem_caches=tuple(cache(c) for c in state.rem_caches),
        pos=_tensor(state.pos, dev))


def adamw_state_from_jax(state: Any, *,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> AdamWState:
    """A reference ``AdamWState`` -> the port's: the int32 step and the two
    moment trees, on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    return AdamWState(step=_tensor(state.step, dev),
                      mu=decoder_params_from_jax(state.mu, device=dev),
                      nu=decoder_params_from_jax(state.nu, device=dev))


def key_from_jax(key_data: Any, *,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> torch.Tensor:
    """The (2,) uint32 pair of ``jax.random.key_data`` -> the port's key, the
    same words in int64 on ``device`` (the card unless ``"cpu"``)."""
    arr = np.asarray(key_data)
    if arr.shape != (2,) or arr.dtype != np.uint32:
        raise ValueError(f"want a (2,) uint32 key data, got {arr.shape} "
                         f"{arr.dtype}")
    return torch.from_numpy(arr.astype(np.int64)).to(resolve_device(device))
