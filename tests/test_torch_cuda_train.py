"""Training on the card: ``flash_dense``'s backward against its plain
version at every head dim the configs use, and the ragged MoE's backward
kernels (dX by ``gmm_dx``, dW by ``gmm_dw``) against theirs.

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

The MoE backward's bf16 dX and dW against ``grouped_matmul_bwd_plain``
(fp32 sums, one rounding): |kernel - plain| <= 2^-7 + 2^-7 |plain|
elementwise, about two bf16 steps, the gate of the forward kernels; two
runs give the same bits.
"""

import math

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa

GRAD_TOL = 2.0 ** -6
GRAD_ATOL = 1e-5
LSE_TOL = 1e-3
MOE_TOL = 2.0 ** -7
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


def _check_grads(got, want, where):
    for name, g, ref in zip("qkv", got, want):
        assert g.shape == ref.shape and g.dtype == torch.bfloat16
        err = float((g.float() - ref).abs().max())
        top = float(ref.abs().max())
        assert err <= GRAD_TOL * top + GRAD_ATOL, (name, where, err, top)


def test_flash_dense_bwd_padded_and_wide_head_dims(dev):
    """Head dim 80 (stablelm-3b, tiles of 128, products at its exact
    width) and 256 (recurrentgemma-2b: MQA, its 10 / 1 heads, windows
    narrower and wider than a tile, the model's 2048): the backward
    against the plain version, and two runs bit-identical."""
    for i, (b, s, h, kvh, hd, window) in enumerate((
            (2, 300, 4, 4, 80, 0), (1, 1000, 4, 2, 80, 100),
            (1, 700, 5, 1, 256, 0), (2, 300, 4, 1, 256, 32),
            (1, 2500, 2, 1, 256, 2048), (2, 520, 10, 1, 256, 130))):
        q, k, v, do = _inputs(dev, b, s, h, kvh, hd, seed=40 + i)
        got = _bwd(q, k, v, do, True, window)
        assert all(torch.equal(x, y) for x, y in
                   zip(got, _bwd(q, k, v, do, True, window)))
        want = fa.flash_attention_dense_bwd_plain(q, k, v, do, window=window)
        _check_grads(got[2:], want, (b, s, h, kvh, hd, window))


def test_moe_bwd_kernels_match_plain(dev):
    """``grouped_matmul_bwd`` on the card (dX by ``gmm_dx``, dW by
    ``gmm_dw``) against ``grouped_matmul_bwd_plain`` at widths with a
    128-column tail and a depth tail, and at 5 m tiles an expert with units
    that wrap ``sched_p`` several times; one launch each, two runs
    bit-identical; ``_expert_matmul`` under autograd reaches both."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.models import moe as tmoe
    for e, r, d, f, p in ((3, 256, 384, 640, 7), (2, 128, 128, 96 + 128, 8),
                          (3, 640, 384, 256, 4)):
        xe = _randn(dev, e, r, d, seed=50)
        w = _randn(dev, e, d, f, seed=51, scale=d ** -0.5)
        dy = _randn(dev, e, r, f, seed=52)
        if f % 128:
            # gmm_dw needs f % 128 == 0: only dX here (depth f with a tail)
            before = gm.GMM_DX.launches
            dx, dw = gm.grouped_matmul_bwd(xe, w, dy, need_dw=False,
                                           sched_p=p)
            assert dw is None and gm.GMM_DX.launches == before + 1
            assert torch.equal(dx, gm.grouped_matmul_bwd(
                xe, w, dy, need_dw=False, sched_p=p)[0])
            want, _ = gm.grouped_matmul_bwd_plain(xe, w, dy, need_dw=False)
            _check_moe(dx, want)
            continue
        before = (gm.GMM_DX.launches, gm.GMM_DW.launches)
        dx, dw = gm.grouped_matmul_bwd(xe, w, dy, sched_p=p)
        assert (gm.GMM_DX.launches, gm.GMM_DW.launches) == (before[0] + 1,
                                                            before[1] + 1)
        again = gm.grouped_matmul_bwd(xe, w, dy, sched_p=p)
        assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
        want_dx, want_dw = gm.grouped_matmul_bwd_plain(xe, w, dy)
        _check_moe(dx, want_dx)
        _check_moe(dw, want_dw)
        leaves = [x.clone().requires_grad_(True) for x in (xe, w)]
        tmoe._expert_matmul(*leaves).backward(dy)
        assert torch.equal(leaves[0].grad, dx)
        assert torch.equal(leaves[1].grad, dw)


def _check_moe(got, want):
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= MOE_TOL + MOE_TOL * want.float().abs()).all()), \
        float(diff.max())
