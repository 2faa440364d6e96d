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

A dense call at a head dim or strides TMA cannot describe runs the
tensor-core kernels of the route of its copies in TMA's layout (the head
dim rounded up to 8, zeros past it), forward and backward, and must give
the bits of those kernels on explicitly zero-padded contiguous copies.

fp16 (``flash_dense_bwd`` at T = __half) is held elementwise to the fp16
gate, |kernel - plain| <= 2^-10 + 2^-10 |plain| (on the gradients divided
by dO's power-of-two scale where dO is scaled): the kernels split P and dS
into two fp16 terms each and form D from the forward's output plus its
rounding residual, so only the outputs' rounding to fp16 is left (see the
note of ``csrc/flash_dense_bwd.cu``).

The MoE backward's bf16 dX and dW against ``grouped_matmul_bwd_plain``
(fp32 sums, one rounding): |kernel - plain| <= 2^-7 + 2^-7 |plain|
elementwise, about two bf16 steps, the gate of the forward kernels; two
runs give the same bits.

The general kernels (``flash_simt_bwd.cu``'s delta pass, ``gmm_dx_simt``
/ ``gmm_dw_simt``) in fp32, plain fp32 FMA against the fp32 plain versions
with TF32 off: flash gradients within 1e-4 + 1e-4 |plain| elementwise, dX
and dW within 1e-5 + 1e-5 |plain| (sums in another order).  The fp32
flash backward on the tensor cores (``flash_f32_bwd.cu``, three TF32
products each) is held to the same 1e-4 + 1e-4 |plain|.  bf16 dX and dW
off ``gmm_dx``'s and ``gmm_dw``'s blocks (``gmm_dx_any`` / ``gmm_dw_any``,
wgmma, either loader) within the bf16 gate above, fp16 within 2^-10 +
2^-10 |plain|.
"""

import math

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa

FP32_FLASH_TOL, FP32_GMM_TOL = 1e-4, 1e-5
FP16_TOL = 2.0 ** -10
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


def _randn(dev, *shape, seed=0, scale=1.0, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)


def _inputs(dev, b, s, h, kvh, hd, seed, dtype=torch.bfloat16):
    return (_randn(dev, b, s, h, hd, seed=seed, dtype=dtype),
            _randn(dev, b, s, kvh, hd, seed=seed + 1, dtype=dtype),
            _randn(dev, b, s, kvh, hd, seed=seed + 2, dtype=dtype),
            _randn(dev, b, s, h, hd, seed=seed + 3, dtype=dtype))


def _assert_close(got, want, tol):
    assert got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol + tol * want.float().abs()).all()), \
        float(diff.max())


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


def _strided(*xs):
    """The same values as views whose heads lie hd + 2 apart, a stride
    TMA cannot describe (the dense entry copies them to TMA's layout)."""
    out = []
    for x in xs:
        buf = torch.zeros(*x.shape[:3], x.shape[3] + 2, dtype=x.dtype,
                          device=x.device)
        buf[..., :x.shape[3]] = x
        out.append(buf[..., :x.shape[3]])
    return out


def _padded_bwd(q, k, v, do, causal, window):
    """What :func:`_bwd` returns, from the route's kernels on explicitly
    zero-padded contiguous copies (the head dim rounded up to 8), launched
    through the packed launchers at the real head dim's scale."""
    hd = q.shape[3]

    def pad(x):
        y = torch.zeros(*x.shape[:3], fa.tma_head_dim(hd), dtype=x.dtype,
                        device=x.device)
        y[..., :hd] = x
        return y

    qp, kp, vp = map(pad, (q, k, v))
    out, lse, o_lo = fa._flash_dense_packed(qp, kp, vp, hd, causal=causal,
                                            window=window, with_lse=True)
    return (out, lse, *fa._flash_dense_bwd_packed(
        qp, kp, vp, pad(out), pad(do), lse, o_lo, hd, causal=causal,
        window=window))


def _autograd_launches(q, k, v, do, causal, window):
    """``flash_attention_dense_bshd`` under autograd on leaves with q's,
    k's and v's strides: the output, the leaves' gradients and the
    launches of every kernel that ran."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    _build.reset_launches()
    out = fa.flash_attention_dense_bshd(*leaves, causal=causal,
                                        window=window)
    out.backward(do)
    torch.cuda.synchronize()
    return out.detach(), [x.grad for x in leaves], {
        n: kern.launches for n, kern in _build.KERNELS.items()
        if kern.launches}


def _pack_launches(hd, strided):
    """``tma_pack``'s launches under autograd: one copy of q, k and v in
    the forward and one in the backward (with dO) where TMA cannot
    describe them, none where it can."""
    return {"tma_pack": 2} if hd % 8 or strided else {}


def _bwd(q, k, v, do, causal, window):
    """The forward's output and lse, then dQ, dK, dV from the forward's
    residuals (lse, and in fp16 the output's rounding residual), as under
    autograd."""
    out, lse, o_lo = fa._flash_dense_cuda(q, k, v, causal=causal,
                                          window=window, with_lse=True)
    return (out, lse, *fa._flash_dense_bwd_cuda(q, k, v, out, do, lse, o_lo,
                                                causal=causal,
                                                window=window))


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
    """Two runs of the backward give the same bits (no atomics): bf16, fp16
    at head dims 64, 80, 128 and 256 (the fp16 instantiations of
    ``flash_dense_bwd``), and fp32 on the tensor cores at head dims 64, 80
    and 128 (route "tf32x3") and 200 and 256 (cluster pairs, forward and
    backward, "tf32x3_256") with windows."""
    for hd, window, dtype in ((128, 0, torch.bfloat16),
                              (64, 100, torch.bfloat16),
                              (64, 100, torch.float16),
                              (80, 50, torch.float16),
                              (128, 0, torch.float16),
                              (256, 2048, torch.float16),
                              (64, 100, torch.float32),
                              (80, 50, torch.float32),
                              (128, 300, torch.float32),
                              (200, 70, torch.float32),
                              (256, 2048, torch.float32)):
        q, k, v, do = _inputs(dev, 2, 1000, 8, 2, hd, seed=3, dtype=dtype)
        assert fa.flash_route(dtype, hd) == (
            "wgmma" if dtype != torch.float32 else
            "tf32x3" if hd <= 128 else "tf32x3_256")
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


def _check_grads(got, want, where, scale=1.0):
    """bf16: max |kernel - plain| <= GRAD_TOL max |plain| + GRAD_ATOL per
    gradient; fp16: the fp16 gate elementwise on the gradients divided by
    ``scale``, the power of two dO was scaled by (an exact division), i.e.
    |kernel - plain| <= FP16_TOL (scale + |plain|)."""
    for name, g, ref in zip("qkv", got, want):
        assert g.shape == ref.shape
        if g.dtype == torch.float16:
            diff = ((g.float() - ref) / scale).abs()
            gate = FP16_TOL + FP16_TOL * (ref / scale).abs()
            assert bool((diff <= gate).all()), (
                name, where, float((diff / gate).max()))
            continue
        assert g.dtype == torch.bfloat16
        err = float((g.float() - ref).abs().max())
        top = float(ref.abs().max())
        assert err <= GRAD_TOL * top + GRAD_ATOL, (name, where, err, top)


def test_flash_dense_bwd_padded_and_wide_head_dims(dev):
    """Head dim 80 (stablelm-3b, tiles of 128, products at its exact
    width) and 256 (recurrentgemma-2b: MQA, its 10 / 1 heads, windows
    narrower and wider than a tile, the model's 2048), and the head
    layouts of granite-20b (48 / 1) and internvl2-1b (14 / 2): the backward
    against the plain version, and two runs bit-identical."""
    for i, (b, s, h, kvh, hd, window) in enumerate((
            (2, 300, 4, 4, 80, 0), (1, 1000, 4, 2, 80, 100),
            (1, 700, 5, 1, 256, 0), (2, 300, 4, 1, 256, 32),
            (1, 2500, 2, 1, 256, 2048), (2, 520, 10, 1, 256, 130),
            # granite-20b's MQA (48 / 1 at hd 128: every q head's dK / dV
            # summed in one CTA) and internvl2-1b's GQA (14 / 2 at hd 64)
            (1, 700, 48, 1, 128, 0), (2, 300, 14, 2, 64, 0))):
        q, k, v, do = _inputs(dev, b, s, h, kvh, hd, seed=40 + i)
        got = _bwd(q, k, v, do, True, window)
        assert all(torch.equal(x, y) for x, y in
                   zip(got, _bwd(q, k, v, do, True, window)))
        want = fa.flash_attention_dense_bwd_plain(q, k, v, do, window=window)
        _check_grads(got[2:], want, (b, s, h, kvh, hd, window))
    # fp16 on the tensor cores at head dims 64, 80, 128 and 256 (P and dS
    # as hi + lo, D from the output and its rounding residual), and at the
    # odd head dims 20, 100 and 250 and on views TMA cannot describe
    # (strided) through the copy to TMA's layout (``tma_pack``, once
    # forward and once backward): under autograd one launch of each pass
    # of flash_dense and flash_dense_bwd and no other kernel, the leaves'
    # gradients the bits of the launchers', those the
    # bits of the route's kernels on explicitly zero-padded contiguous
    # copies, two runs bit-identical, the forward's output within the fp16
    # gate and its lse within LSE_TOL, each gradient within the fp16 gate;
    # GQA, MQA, windows narrower and wider than a tile, ragged s,
    # non-causal, and one case with dO scaled by 2^8 (dS 256 times larger,
    # within fp16's range: see the note of csrc/flash_dense_bwd.cu)
    for i, (b, s, h, kvh, hd, window, causal, scale, strided) in enumerate((
            (2, 300, 4, 2, 64, 0, True, 1.0, False),
            (1, 1000, 4, 2, 80, 100, True, 1.0, False),
            (1, 129, 4, 1, 128, 0, True, 2.0 ** 8, False),
            (1, 200, 2, 2, 128, 0, False, 1.0, False),
            (1, 2100, 4, 1, 128, 300, True, 1.0, False),
            (2, 520, 10, 1, 256, 130, True, 1.0, False),
            (1, 700, 5, 1, 256, 2048, True, 1.0, False),
            (1, 150, 2, 1, 100, 30, True, 1.0, False),
            (2, 300, 4, 2, 64, 0, True, 1.0, True),
            (1, 1000, 8, 2, 128, 0, True, 1.0, True),
            (1, 700, 5, 1, 256, 2048, True, 1.0, True),
            (1, 150, 2, 1, 100, 30, True, 1.0, True),
            (2, 200, 4, 2, 20, 0, False, 1.0, True),
            (1, 300, 2, 1, 250, 64, True, 1.0, False))):
        q, k, v, do = _inputs(dev, b, s, h, kvh, hd, seed=80 + i,
                              dtype=torch.float16)
        do = do * scale
        if strided:
            q, k, v, do = _strided(q, k, v, do)
        where = (b, s, h, kvh, hd, window, causal, scale, strided)
        assert fa.flash_route(torch.float16, hd) == (
            "simt" if hd % 8 else "wgmma")
        assert fa._check_kernel_inputs("flash_dense", q, k, v) == (
            "simt" if hd % 8 or strided else "wgmma")
        out, grads, launches = _autograd_launches(q, k, v, do, causal,
                                                  window)
        assert launches == dict(dict.fromkeys((
            "flash_dense", "flash_dense_bwd_delta", "flash_dense_bwd_dkdv",
            "flash_dense_bwd_dq"), 1), **_pack_launches(hd, strided)), \
            (where, launches)
        got = _bwd(q, k, v, do, causal, window)
        assert torch.equal(out, got[0])
        assert all(torch.equal(a, g) for a, g in zip(grads, got[2:]))
        assert all(torch.equal(a, g) for a, g in
                   zip(got, _padded_bwd(q, k, v, do, causal, window)))
        assert all(torch.equal(a, g) for a, g in
                   zip(got, _bwd(q, k, v, do, causal, window)))
        assert float((got[1] - _plain_lse(q, k, causal, window)).abs().max()) \
            <= LSE_TOL
        plain = fa.flash_attention_dense_plain(
            *fa.broadcast_flatten(q, k, v), causal=causal, window=window)
        _assert_close(got[0], plain.reshape(b, h, s, hd).permute(0, 2, 1, 3),
                      FP16_TOL)
        want = fa.flash_attention_dense_bwd_plain(q, k, v, do, causal=causal,
                                                  window=window)
        _check_grads(got[2:], want, where, scale)
    # fp32, forward and backward: on the tensor cores (route "tf32x3") at
    # head dims 64, 80 and 128 and the padded 16 and 72, with windows, GQA
    # / MQA, non-causal, s off the 16-row stages, and a long MQA sum (dK,
    # dV over 4 heads x 2100 rows); at head dims 136-256 forward and
    # backward on the tensor cores' cluster pairs ("tf32x3_256": 256, 200
    # and 136, non-causal, and recurrentgemma-2b's MQA 10 / 1 at window
    # 2048, dK and dV summing 10 heads x ~2048 rows); the odd head dims
    # 20, 100, 130 and 250 and views TMA cannot describe (strided) through
    # the copy to TMA's layout (``tma_pack``), on the route of the copies'
    # head dim; under autograd one launch of each pass and no other
    # kernel, the bits of
    # the route's kernels on explicitly zero-padded contiguous copies, two
    # runs bit-identical, the forward's output within the gate
    for i, (b, s, h, kvh, hd, window, causal, strided) in enumerate((
            (2, 300, 4, 2, 64, 0, True, False),
            (1, 200, 4, 1, 80, 70, True, False),
            (1, 129, 4, 2, 128, 0, True, False),
            (2, 100, 2, 2, 128, 0, False, False),
            (1, 1000, 8, 2, 128, 200, True, False),
            (2, 333, 4, 1, 64, 40, True, False),
            (1, 300, 4, 4, 72, 0, True, False),
            (2, 17, 4, 2, 16, 0, True, False),
            (1, 2100, 4, 1, 128, 0, True, False),
            (1, 700, 5, 1, 256, 2048, True, False),
            (2, 300, 4, 2, 200, 50, True, False),
            (1, 150, 2, 2, 136, 0, False, False),
            (1, 3000, 10, 1, 256, 2048, True, False),
            (1, 150, 2, 1, 100, 30, True, False),
            (1, 300, 4, 2, 128, 0, True, True),
            (1, 1100, 10, 1, 256, 300, True, True),
            (1, 150, 2, 1, 100, 30, True, True),
            (2, 100, 4, 2, 20, 0, False, True),
            (1, 200, 2, 2, 130, 0, True, False),
            (1, 300, 2, 1, 250, 50, True, True))):
        q, k, v, do = _inputs(dev, b, s, h, kvh, hd, seed=60 + i,
                              dtype=torch.float32)
        if strided:
            q, k, v, do = _strided(q, k, v, do)
        route = fa.flash_route(torch.float32, fa.tma_head_dim(hd))
        assert fa._check_kernel_inputs("flash_dense", q, k, v) == (
            "simt" if hd % 8 or strided else route)
        out, grads, launches = _autograd_launches(q, k, v, do, causal,
                                                  window)
        assert launches == dict(dict.fromkeys((
            fa.FLASH_DENSE_BY_ROUTE[route].name, "flash_simt_bwd_delta",
            *(kern.name for kern in fa.FLASH_F32_BWD_BY_ROUTE[route])),
            1), **_pack_launches(hd, strided)), (hd, strided, launches)
        got = _bwd(q, k, v, do, causal, window)
        assert torch.equal(out, got[0])
        assert all(torch.equal(a, g) for a, g in zip(grads, got[2:]))
        assert all(torch.equal(a, g) for a, g in
                   zip(got, _padded_bwd(q, k, v, do, causal, window)))
        assert all(torch.equal(a, g) for a, g in
                   zip(got, _bwd(q, k, v, do, causal, window)))
        assert float((got[1] - _plain_lse(q, k, causal, window)).abs().max()) \
            <= FP32_FLASH_TOL
        plain = fa.flash_attention_dense_plain(
            *fa.broadcast_flatten(q, k, v), causal=causal, window=window)
        _assert_close(got[0], plain.reshape(b, h, s, hd).permute(0, 2, 1, 3),
                      FP32_FLASH_TOL)
        want = fa.flash_attention_dense_bwd_plain(q, k, v, do, causal=causal,
                                                  window=window)
        for g, ref in zip(got[2:], want):
            assert g.dtype == torch.float32
            _assert_close(g, ref, FP32_FLASH_TOL)


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
    # off those blocks: the reference MoE demo's fp32 shape, the qwen3-moe
    # width, rows, widths and depths off every block, fp16.  bf16 / fp16 dX
    # and dW on ``gmm_dx_any`` / ``gmm_dw_any``: TMA where d and f are
    # multiples of 8 and the bases aligned (R 64, 100, 40 and 200 rows, one
    # CTA; fp16 dW at the qwen3-moe width), else the thread loader (f 764,
    # d 2044, f 70 and 36, an odd f, R 0, bases 2 and 8 bytes off 16); fp32
    # on ``gmm_dx_simt`` / ``gmm_dw_simt``.  Each on the route it must take,
    # bit-identical at sched_p 1, 3 and the SM count; a misaligned call
    # equal to an aligned copy's; one fp32 and one 2-byte call per loader
    # also under autograd through ``_expert_matmul``
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ld, tma = "wgmma_ld", "wgmma_any"
    for (e, r, d, f, p), dt, routes, offset in (
            ((4, 16, 64, 32, 8), torch.float32, ("simt",) * 2, 0),
            ((2, 256, 2048, 768, 132), torch.float32, ("simt",) * 2, 0),
            ((3, 256, 200, 72, 5), torch.float32, ("simt",) * 2, 0),
            ((2, 100, 200, 72, 3), torch.bfloat16, (tma, tma), 0),
            ((2, 40, 24, 56, 7), torch.float16, (tma, tma), 0),
            ((3, 64, 2048, 768, 132), torch.bfloat16, (tma, "wgmma"), 0),
            ((128, 64, 2048, 768, 132), torch.float16, (tma, tma), 0),
            ((2, 200, 264, 136, 1), torch.float16, (tma, tma), 0),
            ((2, 128, 200, 72, 4), torch.bfloat16, (tma, tma), 0),
            ((2, 48, 40, 70, 3), torch.bfloat16, (ld, ld), 0),
            ((16, 64, 2048, 764, 132), torch.bfloat16, (ld, ld), 0),
            ((16, 64, 2048, 764, 132), torch.float16, (ld, ld), 0),
            ((3, 64, 2044, 768, 5), torch.float16, (ld, ld), 0),
            ((2, 40, 72, 36, 1), torch.float16, (ld, ld), 0),
            ((2, 128, 72, 33, 3), torch.bfloat16, (ld, ld), 0),
            ((2, 0, 72, 40, 3), torch.bfloat16, (ld, ld), 0),
            ((3, 64, 2048, 768, 132), torch.float16, (ld, ld), 1),
            ((2, 72, 136, 64, 3), torch.float16, (ld, ld), 4),
            ((2, 60, 30, 34, 1), torch.float32, ("simt",) * 2, 0)):
        if offset:   # xe and dy: contiguous views off 16 bytes
            xe = _randn(dev, e * r * d + offset, seed=53,
                        dtype=dt)[offset:].view(e, r, d)
            dy = _randn(dev, e * r * f + offset, seed=55,
                        dtype=dt)[offset:].view(e, r, f)
        else:
            xe = _randn(dev, e, r, d, seed=53, dtype=dt)
            dy = _randn(dev, e, r, f, seed=55, dtype=dt)
        w = _randn(dev, e, d, f, seed=54, scale=d ** -0.5, dtype=dt)
        got = (gm.gmm_dx_route(dt, dt, r, d, f, gm._aligned(dy, w)),
               gm.gmm_dw_route(dt, dt, r, d, f, gm._aligned(xe, dy)))
        assert got == routes, ((e, r, d, f), dt, got)
        kx, kw = gm.GMM_DX_BY_ROUTE[got[0]], gm.GMM_DW_BY_ROUTE[got[1]]
        before = (kx.launches, kw.launches)
        dx, dw = gm.grouped_matmul_bwd(xe, w, dy, sched_p=p)
        assert (kx.launches, kw.launches) == (before[0] + 1, before[1] + 1)
        assert dx.dtype == dw.dtype == dt
        for p2 in (1, 3, n_sm):
            again = gm.grouped_matmul_bwd(xe, w, dy, sched_p=p2)
            assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
        if offset:
            aligned = gm.grouped_matmul_bwd(xe.clone(), w, dy.clone(),
                                            sched_p=p)
            assert torch.equal(dx, aligned[0]) and torch.equal(dw, aligned[1])
        want_dx, want_dw = gm.grouped_matmul_bwd_plain(xe, w, dy)
        tol = {torch.float32: FP32_GMM_TOL, torch.bfloat16: MOE_TOL,
               torch.float16: 2.0 ** -10}[dt]
        _assert_close(dx, want_dx, tol)
        _assert_close(dw, want_dw, tol)
        if (e, r, d, f) in ((2, 256, 2048, 768), (3, 256, 200, 72),
                            (2, 128, 200, 72), (2, 128, 72, 33)):
            leaves = [x.clone().requires_grad_(True) for x in (xe, w)]
            tmoe._expert_matmul(*leaves).backward(dy)
            assert torch.equal(leaves[0].grad, dx)
            assert torch.equal(leaves[1].grad, dw)


def _check_moe(got, want):
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= MOE_TOL + MOE_TOL * want.float().abs()).all()), \
        float(diff.max())
