"""``jax.random``'s default generator, bit for bit, as integer tensor code.

The reference samples with ``jax.random`` (``serve/engine.py``,
``train/steps.py``), whose default PRNG is threefry2x32 with
``jax_threefry_partitionable`` on.  Threefry is a fixed function of
32-bit additions, rotations and xors, so it is reproduced here exactly,
on the CPU and on the card alike:

  * ``key(seed)``: the reference's ``key_data(jax.random.key(seed))``, the
    pair ``[0, seed mod 2^32]`` (64-bit mode off);
  * ``split(key, num)``: the partitionable split, key ``i`` being threefry
    of the counter pair ``(i >> 32, i & (2^32 - 1))``;
  * ``bits(key, shape)``: ``random_bits`` for uint32, the two threefry
    words of each element's row-major counter xor-ed together;
  * ``uniform``: float32 by the mantissa trick (``bits >> 9`` under the
    exponent of 1.0, minus 1), then ``u * (maxval - minval) + minval`` as
    one fused multiply-add, as XLA compiles it;
  * ``gumbel``: ``-log(-log(uniform(tiny, 1)))`` (``mode="low"``);
  * ``categorical``: Gumbel-max, ``argmax(gumbel + logits)``.

A key is the reference's key data, a (2,) pair of uint32 words, held in an
int64 tensor (CUDA implements few uint32 operators): every word stays in
[0, 2^32), sums are masked back to 32 bits and right shifts see only
non-negative values, so they are logical.  A key on the CPU is read as
two Python ints, which costs no device sync: ``split`` of such a key runs
on the host in Python ints, and ``bits``, ``uniform``, ``gumbel`` and
``categorical`` draw on the device they are asked for, taking the two
words as scalars.  A decode step that keeps its key on the host thus
launches nothing on the card for its split.

Everything up to the uniform's floats is exact.  The Gumbel noise takes
both logs in float64 and rounds once to float32, so it is the same on
every device and path to the last bit but for rare double roundings, and
within an ulp or two of XLA's float32 logs; the sampled tokens agree
except where two noisy logits lie closer than that.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from .device import resolve_device

__all__ = ["key", "split", "bits", "uniform", "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

_ONE_F32 = 0x3F800000     # the bits of 1.0f


def key(seed: int, *, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` on ``device`` (the card
    unless ``"cpu"``): ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _rotl(v, r: int):
    return ((v << r) & _MASK) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1`` under
    the key words ``k0``, ``k1``; the reference's unrolled lowering, step
    for step.  Each argument is an int64 tensor or a Python int, every
    value in [0, 2^32)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _counters(shape: Sequence[int], device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The row-major element index of ``shape`` as (high, low) 32-bit
    words: the reference's ``iota_2x32_shape``."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return (idx >> 32).reshape(shape), (idx & _MASK).reshape(shape)


def _words(k: torch.Tensor):
    """The key's two words: Python ints from a key on the CPU, 0-d tensors
    from one on the card (reading those would wait for the device)."""
    return tuple(k.tolist()) if k.device.type == "cpu" else (k[0], k[1])


def _shape(shape: Union[int, Sequence[int]]) -> tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def split(k: torch.Tensor, num: Union[int, Sequence[int]] = 2
          ) -> torch.Tensor:
    """``jax.random.split``: keys of shape (*num, 2) on the key's device.
    A key on the CPU is split in Python ints, key by key: meant for the
    few keys a decode step splits."""
    shape = _shape(num)
    if k.device.type == "cpu":
        k0, k1 = _words(k)
        keys = [threefry2x32(k0, k1, i >> 32, i & _MASK)
                for i in range(math.prod(shape))]
        return torch.tensor(keys, dtype=torch.int64).reshape(*shape, 2)
    x0, x1 = threefry2x32(*_words(k), *_counters(shape, k.device))
    return torch.stack([x0, x1], dim=-1)


def bits(k: torch.Tensor, shape: Union[int, Sequence[int]] = (),
         device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: 32-bit words in int64, on
    ``device`` (default: the key's)."""
    device = k.device if device is None else torch.device(device)
    x0, x1 = threefry2x32(*_words(k), *_counters(_shape(shape), device))
    return x0 ^ x1


def uniform(k: torch.Tensor, shape: Union[int, Sequence[int]] = (),
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform``: floats in [minval, maxval) on ``device``
    (default: the key's).  float32 only, the reference's logits dtype (XLA
    rounds narrower dtypes' scaling in a way not reproduced here)."""
    if dtype != torch.float32:
        raise TypeError(f"uniform draws float32, got {dtype}")
    floats = (((bits(k, shape, device) >> 9) | _ONE_F32).to(torch.int32)
              .view(torch.float32) - 1.0)
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    return torch.maximum(lo, torch.addcmul(lo, floats, hi - lo))


def gumbel(k: torch.Tensor, shape: Union[int, Sequence[int]] = (),
           dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ``mode="low"``, the two logs
    taken in float64 and rounded once (module docstring)."""
    u = uniform(k, shape, dtype, minval=torch.finfo(dtype).tiny, maxval=1.0,
                device=device)
    return (-torch.log(-torch.log(u.double()))).to(dtype)


def categorical(k: torch.Tensor, logits: torch.Tensor, axis: int = -1
                ) -> torch.Tensor:
    """``jax.random.categorical`` with replacement, one sample per
    distribution: the index of the largest ``gumbel + logits`` along
    ``axis`` (the first on a tie, as ``jnp.argmax``), drawn on the logits'
    device."""
    noisy = gumbel(k, logits.shape, logits.dtype, logits.device) + logits
    return torch.argmax(noisy, dim=axis)
