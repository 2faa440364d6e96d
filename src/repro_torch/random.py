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
  * ``categorical``: Gumbel-max, ``argmax(gumbel + logits)``;
  * ``fold_in(key, data)``: threefry of the counter pair ``(0, data)``;
  * ``randint``: two words an element from the two halves of a split,
    folded into the span with 32-bit wrapping arithmetic (``_randint``);
  * ``normal``: ``sqrt(2) erfinv(uniform(nextafter(-1, 0), 1))``, erfinv
    by the float32 polynomial XLA lowers ``erf_inv`` to (Giles'), its
    multiply-adds fused.

A key is the reference's key data, a (2,) pair of uint32 words, held in an
int64 tensor (CUDA implements few uint32 operators): every word stays in
[0, 2^32), sums are masked back to 32 bits and right shifts see only
non-negative values, so they are logical.  A key on the CPU is read as
two Python ints, which costs no device sync: ``split`` of such a key runs
on the host in Python ints, and ``bits``, ``uniform``, ``gumbel`` and
``categorical`` draw on the device they are asked for, taking the two
words as scalars.  A decode step that keeps its key on the host thus
launches nothing on the card for its split.

Everything up to the uniform's floats is exact, and so are ``fold_in``
and ``randint``.  ``normal`` is within a few ulp of XLA's (the
polynomial's log1p is PyTorch's; 3 at most in the tests, held to 4).  The Gumbel noise takes
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

__all__ = ["key", "split", "fold_in", "bits", "uniform", "randint",
           "normal", "gumbel", "categorical"]

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


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the key of threefry of ``(0, data mod
    2^32)`` under ``k``, on the key's device."""
    x0, x1 = threefry2x32(*_words(k), 0, int(data) & _MASK)
    if k.device.type == "cpu":
        return torch.tensor([x0, x1], dtype=torch.int64)
    return torch.stack([x0, x1])


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


def randint(k: torch.Tensor, shape: Union[int, Sequence[int]], minval: int,
            maxval: int, dtype: torch.dtype = torch.int32,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` for int32 (the reference's default integer
    type) and scalar int32 bounds: integers in [minval, maxval) on
    ``device`` (default: the key's).  As ``jax._src.random._randint``:
    higher and lower words from the two keys of
    ``split(k)``, ``((hi % span) * (2^32 % span) + lo % span) % span`` in
    uint32 arithmetic, added to minval."""
    if dtype != torch.int32:
        raise TypeError(f"randint draws int32, got {dtype}")
    minval, maxval = int(minval), int(maxval)
    if not -2 ** 31 <= min(minval, maxval) <= max(minval, maxval) < 2 ** 31:
        # the reference (64-bit mode off) refuses such bounds as well
        raise OverflowError(f"randint bounds must fit int32, got {minval}, "
                            f"{maxval}")
    span = (maxval - minval) & _MASK if maxval > minval else 1
    # XLA's unsigned remainder by 0 (a full 2^32 span) leaves x as it is
    def rem(x):
        return x % span if span else x

    mult = rem((rem(1 << 16) ** 2) & _MASK)        # a uint32 square
    k1, k2 = split(k)
    higher = bits(k1, shape, device)
    lower = bits(k2, shape, device)
    # rem(higher) < 2^32 and mult < 2^16: the product fits in int64
    off = rem((((rem(higher) * mult) & _MASK) + rem(lower)) & _MASK)
    val = (minval + off + 2 ** 31) & _MASK
    return (val - 2 ** 31).to(torch.int32)


#: the float32 coefficients of XLA's erf_inv (Giles' polynomial), for
#: w = -log1p(-x^2) < 5 (in w - 2.5) and >= 5 (in sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: each step ``c + p w`` one fused multiply-add
    (taken in float64, where the product is exact, and rounded once)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    lt = torch.tensor(_ERFINV_LT5, dtype=torch.float32).double()
    ge = torch.tensor(_ERFINV_GE5, dtype=torch.float32).double()
    p = torch.where(small, lt[0].to(x.device), ge[0].to(x.device))
    for i in range(1, len(_ERFINV_LT5)):
        c = torch.where(small, lt[i].to(x.device), ge[i].to(x.device))
        p = torch.addcmul(c, p, w).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1, x * math.inf, out)


def normal(k: torch.Tensor, shape: Union[int, Sequence[int]] = (),
           dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """``jax.random.normal``: float32 standard normals on ``device``
    (default: the key's), ``sqrt(2) erfinv(u)`` of a uniform u in
    (-1, 1), within a few ulp of the reference's (module docstring)."""
    if dtype != torch.float32:
        raise TypeError(f"normal draws float32, got {dtype}")
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(k, shape, dtype, minval=lo, maxval=1.0, device=device)
    sqrt2 = torch.tensor(math.sqrt(2), dtype=dtype, device=u.device)
    return sqrt2 * _erfinv_f32(u)


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
