"""``repro_torch.random``'s ``fold_in``, ``randint`` and ``normal`` against
``jax.random`` on the CPU, on odd and large shapes.

Tolerances:
  * ``fold_in`` and ``randint``: bit for bit (threefry and 32-bit integer
    arithmetic);
  * ``normal``: within NORMAL_ULPS ulp.  It is ``sqrt(2) erfinv(u)`` of the
    same uniform ``u`` (bit for bit), the erfinv by the float32 polynomial
    XLA lowers ``erf_inv`` to, each multiply-add fused as XLA fuses it; the
    polynomial's ``log1p`` is PyTorch's, not XLA's, and the two differ by an
    ulp or so, which the polynomial and the final product carry on (3 ulp
    at most seen).
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

from repro_torch import random as trandom

SEEDS = (0, 1, 42, 2 ** 31 + 5)
NORMAL_ULPS = 4


def test_fold_in_is_bit_exact():
    n = 0
    for seed in SEEDS:
        jk, tk = jax.random.key(seed), trandom.key(seed, device="cpu")
        for data in (0, 1, 99, 123456789, 2 ** 32 - 1):
            want = np.asarray(jax.random.key_data(jax.random.fold_in(jk, data)))
            got = trandom.fold_in(tk, data)
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
            # a folded key draws the reference's bits
            np.testing.assert_array_equal(
                trandom.bits(got, (3, 5)).numpy(),
                np.asarray(jax.random.bits(jax.random.fold_in(jk, data),
                                           (3, 5))).astype(np.int64))
            n += 1
    print(f"compared {n} folded keys")


@pytest.mark.parametrize("shape,lo,hi", [
    ((4, 1), 0, 151936),           # the serve demo's first tokens
    ((3, 5, 7), -10, 10),
    ((1001,), 0, 65536),           # a span of 2^16: the multiplier wraps
    ((999,), 0, 65537),
    ((513, 3), -2 ** 31, 2 ** 31 - 1),
    ((17,), 5, 5),                 # an empty range returns minval
    ((64, 64, 3), 7, 3),
])
def test_randint_is_bit_exact(shape, lo, hi):
    n = 0
    for seed in SEEDS:
        want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo,
                                             hi))
        got = trandom.randint(trandom.key(seed, device="cpu"), shape, lo, hi)
        assert want.dtype == np.int32 and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        n += want.size
    print(f"compared {n} integers")


def test_normal_within_ulps():
    n = worst = 0
    for seed in SEEDS:
        for shape in ((1001,), (3, 17, 5), (4, 64, 64), (96, 1025)):
            want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
            got = trandom.normal(trandom.key(seed, device="cpu"), shape).numpy()
            assert got.dtype == want.dtype == np.float32
            # float32 bit patterns of one sign: the ulp distance
            gap = np.abs(got.view(np.int32).astype(np.int64)
                         - want.view(np.int32).astype(np.int64))
            assert np.array_equal(np.sign(got), np.sign(want))
            worst = max(worst, int(gap.max()))
            n += want.size
    assert worst <= NORMAL_ULPS, worst
    with pytest.raises(OverflowError):
        trandom.randint(trandom.key(0, device="cpu"), (2,), 0, 2 ** 40)
    print(f"compared {n} normals, worst gap {worst} ulp")
