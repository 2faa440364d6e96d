"""Training on the card: ``flash_dense``'s backward against its plain
version, and the MoE kernel path's refusal to train.

Every test here carries the ``cuda`` marker and skips without a GPU.  On a
machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

The file imports only torch, numpy and ``repro_torch``.  Tolerance of a
bf16 gradient of ``csrc/flash_dense_bwd.cu`` against the fp32 plain version
(``flash_attention_dense_bwd_plain``): max |kernel - plain| <= 2^-6 max
|plain| + 1e-5 per tensor (the absolute 1e-5 for a gradient that is 0 in
exact arithmetic: at window 1 a row's P is 1 on its diagonal and dS = P
(dP - D) = 0, which the kernel's bf16 O and ex2.approx leave at ~1e-6).
The kernel rounds P and dS to bf16 before their
products (a relative step of 2^-9 each) and the result to bf16 once; the
sums over 64 to 4096 columns average those roundings.  The forward's lse
is held to the plain log-sum-exp within 1e-3 (the kernel's exp2 is
``ex2.approx``).  Two runs of the backward must give the same bits.
"""

import math

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa

GRAD_TOL = 2.0 ** -6
GRAD_ATOL = 1e-5
LSE_TOL = 1e-3
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(
        torch.bfloat16)


def _inputs(dev, b, s, h, kvh, hd, seed):
    return (_randn(dev, b, s, h, hd, seed=seed),
            _randn(dev, b, s, kvh, hd, seed=seed + 1),
            _randn(dev, b, s, kvh, hd, seed=seed + 2),
            _randn(dev, b, s, h, hd, seed=seed + 3))


def _plain_lse(q, k, causal, window):
    """(b, h, s) fp32 log-sum-exp of the masked, scaled scores."""
    b, s, h, hd = q.shape
    qf, kf, _ = fa.broadcast_flatten(q, k, k)
    sc = torch.einsum("bsd,btd->bst", qf.float(), kf.float()) / math.sqrt(hd)
    i = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window > 0:
        mask &= (i[:, None] - i[None, :]) < window
    sc = torch.where(mask, sc, -1e30)
    return torch.logsumexp(sc, dim=-1).reshape(b, h, s)


def _bwd(q, k, v, do, causal, window):
    out, lse = fa._flash_dense_cuda(q, k, v, causal=causal, window=window,
                                    with_lse=True)
    return (out, lse, *fa._flash_dense_bwd_cuda(q, k, v, out, do, lse,
                                                causal=causal, window=window))


@pytest.mark.parametrize("hd,windowed", [(64, False), (64, True),
                                         (128, False), (128, True)])
def test_flash_dense_bwd_matches_plain(dev, hd, windowed):
    """dQ, dK, dV of the kernel against the plain version (GQA, MQA, ragged
    s, a window narrower than a tile and one wider), and the forward's lse
    and output (the same bits as without lse)."""
    cases = ([(2, 300, 4, 2, 32, True), (1, 1000, 8, 1, 200, True),
              (1, 129, 2, 2, 1, True), (1, 200, 4, 2, 70, False)]
             if windowed else
             [(2, 300, 4, 2, 0, True), (1, 1024, 8, 1, 0, True),
              (2, 129, 4, 4, 0, True), (1, 200, 2, 1, 0, False)])
    for i, (b, s, h, kvh, window, causal) in enumerate(cases):
        q, k, v, do = _inputs(dev, b, s, h, kvh, hd, seed=10 * i)
        out, lse, dq, dk, dv = _bwd(q, k, v, do, causal, window)
        assert torch.equal(out, fa._flash_dense_cuda(q, k, v, causal=causal,
                                                     window=window))
        assert float((lse - _plain_lse(q, k, causal, window)).abs().max()) \
            <= LSE_TOL
        want = fa.flash_attention_dense_bwd_plain(q, k, v, do, causal=causal,
                                                  window=window)
        for name, got, ref in zip("qkv", (dq, dk, dv), want):
            assert got.shape == ref.shape and got.dtype == torch.bfloat16
            err = float((got.float() - ref).abs().max())
            top = float(ref.abs().max())
            assert err <= GRAD_TOL * top + GRAD_ATOL, (
                name, (b, s, h, kvh, hd, window), err, top)


def test_flash_dense_bwd_is_deterministic(dev):
    """Two runs of the backward give the same bits (no atomics)."""
    for hd, window in ((128, 0), (64, 100)):
        q, k, v, do = _inputs(dev, 2, 1000, 8, 2, hd, seed=3)
        first = _bwd(q, k, v, do, True, window)
        second = _bwd(q, k, v, do, True, window)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_flash_dense_autograd_counts_each_kernel(dev):
    """``flash_attention_dense_bshd`` under autograd: the gradients reach q,
    k and v through the Function, one launch of each kernel."""
    q, k, v, do = _inputs(dev, 2, 300, 4, 2, 128, seed=5)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    _build.reset_launches()
    out = fa.flash_attention_dense_bshd(*leaves, causal=True, window=0)
    out.backward(do)
    torch.cuda.synchronize()
    launches = {n: _build.KERNELS[n].launches for n in (
        "flash_dense", "flash_dense_bwd_delta", "flash_dense_bwd_dkdv",
        "flash_dense_bwd_dq")}
    assert launches == dict.fromkeys(launches, 1), launches
    dq, dk, dv = _bwd(q, k, v, do, True, 0)[2:]
    for leaf, want in zip(leaves, (dq, dk, dv)):
        assert torch.equal(leaf.grad, want)


def test_flash_dense_bwd_unsupported_head_dim_raises(dev):
    """Head dims 80 and 256 raise (no fallback), in the forward when a
    gradient is wanted and in the backward's wrapper."""
    for hd in (80, 256):
        q, k, v, do = _inputs(dev, 1, 256, 2, 1, hd, seed=7)
        with pytest.raises(ValueError, match="ROADMAP"):
            fa.flash_attention_dense_bshd(q.requires_grad_(True), k, v)
        out, lse = fa._flash_dense_cuda(q.detach(), k, v, causal=True,
                                        window=0, with_lse=True)
        with pytest.raises(ValueError, match="ROADMAP"):
            fa._flash_dense_bwd_cuda(q.detach(), k, v, out, do, lse,
                                     causal=True, window=0)


def test_expert_matmul_raises_under_autograd(dev):
    """``gmm`` has no backward yet: the ragged MoE path refuses to train on
    the card instead of returning an output without a gradient."""
    from repro_torch.models import moe as tmoe
    xe = _randn(dev, 2, 128, 64, seed=9).requires_grad_(True)
    w = _randn(dev, 2, 64, 128, seed=10)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmoe._expert_matmul(xe, w)
    with torch.no_grad():
        assert tmoe._expert_matmul(xe, w).shape == (2, 128, 128)
