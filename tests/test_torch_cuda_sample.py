"""The sampler (``repro_torch.random``) on the card against the same calls
on the CPU.  Every test here carries the ``cuda`` marker and skips without
a GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sample.py

The file imports only torch, numpy and ``repro_torch``.  The integer
threefry words and the uniform floats must be equal bit for bit (the
CPU's are ``jax.random``'s, tests/test_torch_random.py); the Gumbel noise
within GUMBEL_ULPS ulp of max(|g|, 1) (both devices take its logs in
float64 and round once, so it is equal but for rare double roundings);
the sampled tokens equal, counted, from a key on the card and from a key
on the host drawing on the card, as the engine draws.
"""

import numpy as np
import pytest
import torch

from repro_torch import random as trandom

pytestmark = pytest.mark.cuda

SEEDS = (0, 1, 42, 2 ** 31 - 1)
SHAPES = ((), (1,), (5,), (3, 7, 11), (4, 151936))
GUMBEL_ULPS = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the sampler's CUDA path)")
    return torch.device("cuda")


def test_split_bits_uniform_equal_cpu(dev):
    for seed in SEEDS:
        kc, kg = trandom.key(seed, device="cpu"), trandom.key(seed, device=dev)
        assert kg.device.type == "cuda"
        for num in (2, 3, 7):
            assert torch.equal(trandom.split(kg, num).cpu(),
                               trandom.split(kc, num))
        for shape in SHAPES:
            assert torch.equal(trandom.bits(kg, shape).cpu(),
                               trandom.bits(kc, shape)), (seed, shape)
            for lo, hi in ((0.0, 1.0), (-3.7, 5.1)):
                got = trandom.uniform(kg, shape, torch.float32, lo, hi)
                want = trandom.uniform(kc, shape, torch.float32, lo, hi)
                assert torch.equal(got.cpu(), want), (seed, shape, lo)


def test_gumbel_and_categorical_match_cpu(dev):
    rng = np.random.default_rng(0)
    worst, compared, equal = 0.0, 0, 0
    for seed in SEEDS:
        kc, kg = trandom.key(seed, device="cpu"), trandom.key(seed, device=dev)
        want = trandom.gumbel(kc, (4, 151936)).numpy()
        got = trandom.gumbel(kg, (4, 151936)).cpu().numpy()
        ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
        worst = max(worst, float((np.abs(got - want) / ulp).max()))
        logits = torch.from_numpy(
            (3 * rng.standard_normal((64, 32000))).astype(np.float32))
        tc = trandom.categorical(kc, logits)
        for k in (kg, kc):
            tg = trandom.categorical(k, logits.to(dev)).cpu()
            compared += tc.numel()
            equal += int((tc == tg).sum())
    print(f"gumbel max gap {worst} ulp; categorical {equal} of {compared}")
    assert worst <= GUMBEL_ULPS
    assert compared == 2 * 64 * len(SEEDS) and equal == compared
