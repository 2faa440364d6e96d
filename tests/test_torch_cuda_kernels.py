"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU.  On a
machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The file imports only torch, numpy and ``repro_torch`` so that it runs
where JAX is not installed.  Tolerance for bf16 outputs:
|kernel - plain| <= 2^-7 + 2^-7 * |plain| (about two bf16 rounding steps;
the kernels sum in another order than the fp32 plain versions before the
final rounding), also for ``gmm_any``'s.  The general kernels' fp32 outputs (``gmm_simt``,
``flash_*_simt``; plain fp32 FMA, TF32 off on both sides) are held to
1e-5 + 1e-5 |plain| for the grouped matmul and 1e-4 + 1e-4 |plain| for
flash attention (sums of up to thousands of products in another order),
and so are ``flash_dense_f32``, ``flash_dense_f32_256`` and
``flash_sched_f32`` (three TF32 products each, about 2^-20 relative error
a product); fp16 outputs to 2^-10 + 2^-10 |plain| (two fp16 rounding
steps), the general kernels' and the fp16 instantiations of
``flash_dense`` and ``flash_sched`` (the scheduled calls against the fp32
plain version).  Across schedules and ``sched_p`` the outputs must be
bit-identical.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import REGISTRY
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul

TOL = 2.0 ** -7
#: the general kernels' tolerances by output dtype: (gmm, flash)
SIMT_TOL = {torch.float32: (1e-5, 1e-4), torch.float16: (2.0 ** -10,) * 2,
            torch.bfloat16: (TOL, TOL)}
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


def _assert_close(got, want, tol=TOL):
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol + tol * want.float().abs()).all()), float(diff.max())


@pytest.mark.parametrize("case", [
    # groups of (b, s, h, kvh, hd, block, window, causal, kv_lens, strided);
    # kv_lens None draws them from the seed s
    ((2, 300, 4, 2, 128, 128, 0, True, None, False),
     (2, 129, 4, 2, 128, 128, 0, True, None, False),    # one row past a tile
     (2, 300, 4, 2, 128, 64, 0, True, None, False),     # 64-blocks, ragged s
     # hd 256 (64-column kv tiles): one row past a q tile, ragged lens
     (2, 129, 4, 2, 256, 128, 0, True, None, False)),
    ((3, 200, 2, 1, 64, 64, 70, True, None, False),
     (2, 300, 4, 2, 128, 64, 0, True, None, False),     # a tile spans 2 blocks
     (2, 300, 4, 1, 128, 128, 32, True, None, False),   # window < a tile
     (2, 300, 4, 1, 80, 64, 40, True, None, False)),    # hd 80, MQA, window
    ((1, 96, 2, 2, 128, 512, 0, False, None, False),
     (3, 300, 4, 2, 128, 128, 0, True, [0, 300, 77], False),   # kv_len 0
     (2, 300, 2, 2, 64, 64, 40, False, [0, 129], False),
     (3, 200, 4, 2, 32, 64, 0, True, [0, 200, 77], False),     # hd 32
     # kv blocks of 100 columns: fp32's tiles start at aligned columns
     (2, 333, 4, 2, 128, 100, 60, True, None, False)),
    ((2, 1024, 8, 2, 128, 512, 0, True, None, False),
     (2, 300, 4, 2, 128, 128, 0, True, None, True),     # strided heads
     (2, 300, 4, 2, 64, 64, 32, True, None, True),
     (2, 333, 10, 1, 256, 128, 100, True, None, False),  # hd 256 MQA, window
     (2, 300, 4, 2, 80, 128, 0, True, None, True)),     # hd 80, strided
])
def test_flash_sched_matches_plain_and_is_schedule_free(dev, case):
    """Each case against the fp32 plain version, then bit-identical for all
    27 techniques at sched_p 1 (one CTA wraps the stage ring across every
    unit), 8 and the SM count; head dims 64 and 128, and 32 (padded to
    64), 80 (its exact width) and 256 (64-column kv tiles in 2 stages).
    The first and the last case of each group also in fp16 (the fp16
    instantiations of ``flash_sched``) and in fp32: on the tensor cores
    (``flash_sched_f32``) up to head dim 128, on the general kernel at
    256.

    The edge cases share the four items instead of being items of their
    own only while the reference's order-dependent
    ``test_shard_as_applies_constraint`` stays unfixed (ROADMAP.md,
    faults): more items here move this file in pytest-xdist's loadfile
    queue, and that reference test then fails.
    """
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    runs = [(c, dt) for i, c in enumerate(case)
            for dt in ((torch.bfloat16, torch.float16, torch.float32)
                       if i in (0, len(case) - 1) else (torch.bfloat16,))]
    for (b, s, h, kvh, hd, blk, window, causal, lens, strided), dt in runs:
        if strided:
            # q, k and v as views of one (b, s, 3, h, hd) buffer
            buf = _randn(dev, b, s, 3, h, hd, seed=5, dtype=dt)
            q, k, v = buf[:, :, 0], buf[:, :, 1, :kvh], buf[:, :, 2, :kvh]
        else:
            q, k, v = (_randn(dev, b, s, n, hd, seed=i, dtype=dt)
                       for i, n in enumerate((h, kvh, kvh)))
        lens = (np.random.default_rng(s).integers(1, s + 1, size=b)
                if lens is None else np.asarray(lens))
        kw = dict(causal=causal, window=window, block_q=blk, block_k=blk,
                  kv_lens=lens)
        kernel = fa.FLASH_SCHED_BY_ROUTE[fa._check_kernel_inputs(
            "flash_sched", q, k, v)]
        assert kernel is {torch.bfloat16: fa.FLASH_SCHED,
                          torch.float16: fa.FLASH_SCHED,
                          torch.float32: fa.FLASH_SCHED_F32 if hd <= 128
                          else fa.FLASH_SCHED_SIMT}[dt]
        before = kernel.launches
        out = flash_attention(q, k, v, schedule="static", sched_p=5, **kw)
        assert kernel.launches == before + 1
        qf, kf, vf = (x.float() for x in fa.broadcast_flatten(q, k, v))
        want = fa.flash_attention_sched_plain(
            qf, kf, vf, kv_lens=np.repeat(lens, h), causal=causal,
            window=window)
        _assert_close(out, want.reshape(b, h, s, hd).permute(0, 2, 1, 3),
                      SIMT_TOL[dt][1])
        for tech in REGISTRY:
            for p in (1, 8, n_sm):
                assert torch.equal(flash_attention(
                    q, k, v, schedule=tech, sched_p=p, **kw), out), (tech, p)


def test_flash_bhsd_entry_and_errors(dev):
    """The bhsd entry; fp32 at hd 64 and 80 on the tensor cores
    (``flash_sched_f32``), fp16 on ``flash_sched``, fp32 at hd 256 and a
    bf16 head dim of 20 on the general kernel, with ragged lens and a
    window, against the fp32 plain version; what no kernel takes raises,
    with no route to the plain version."""
    q = _randn(dev, 4, 256, 64)
    out = fa.flash_attention_sched_bhsd(q, q, q, schedule="gss", block_q=128,
                                        block_k=128)
    _assert_close(out, fa.flash_attention_sched_plain(q, q, q))
    # any head dim that is a multiple of 8 up to 256 runs (32: padded to 64)
    x = _randn(dev, 2, 200, 32)
    before = fa.FLASH_SCHED.launches
    _assert_close(fa.flash_attention_sched_bhsd(x, x, x, schedule="fac2"),
                  fa.flash_attention_sched_plain(x, x, x))
    assert fa.FLASH_SCHED.launches == before + 1
    for dt, hd, want_kernel in (
            (torch.float32, 64, fa.FLASH_SCHED_F32),
            (torch.float16, 128, fa.FLASH_SCHED),
            (torch.bfloat16, 20, fa.FLASH_SCHED_SIMT),
            (torch.float32, 80, fa.FLASH_SCHED_F32),
            (torch.float32, 256, fa.FLASH_SCHED_SIMT)):
        y = _randn(dev, 3, 300, hd, seed=hd, dtype=dt)
        lens = [300, 77, 1]
        kernel = fa.FLASH_SCHED_BY_ROUTE[fa.flash_route(dt, hd)]
        assert kernel is want_kernel
        launches = kernel.launches
        got = fa.flash_attention_sched_bhsd(y, y, y, schedule="fac2",
                                            kv_lens=lens, window=50,
                                            block_q=128, block_k=64)
        assert kernel.launches == launches + 1
        assert got.dtype == dt
        _assert_close(got, fa.flash_attention_sched_plain(
            *(y.float(),) * 3, kv_lens=lens, window=50), SIMT_TOL[dt][1])
    y = _randn(dev, 1, 64, 1, 264)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(y, y, y, schedule="fac2")
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        flash_attention(*(q[:, :, None].double(),) * 3, schedule="fac2")
    assert fa.FLASH_SCHED.launches == before + 2


@pytest.mark.parametrize("case", [
    # b, s, h, kvh, hd, window, causal
    (1, 300, 4, 2, 128, 0, True),      # GQA, s not a multiple of the tile
    (2, 200, 2, 1, 64, 32, True),      # MQA, window narrower than a tile
    (1, 520, 4, 4, 128, 200, True),    # MHA, window 200
    (1, 96, 2, 2, 128, 0, False),      # non-causal, one partial tile
    (2, 257, 6, 3, 64, 0, False),      # non-causal GQA, ragged tail
    (1, 1000, 8, 2, 128, 70, False),   # non-causal window
    (1, 2560, 8, 2, 128, 0, True),     # the 2-layer prefill's length
])
def test_flash_dense_matches_plain(dev, case):
    _check_flash_dense(dev, case)


def test_flash_dense_tile_edges(dev):
    """The edges of the kernel's 128 x 128 tiles, and the head dims that
    are padded inside the kernel: 80 (stablelm-3b, tiles of 128, products
    at its exact width) and 256
    (recurrentgemma-2b, 64-column K / V tiles in 2 stages), causal, windowed
    MQA, non-causal, a window of 2048 and windows narrower than a tile, and
    the head layouts of granite-20b, internvl2-1b, musicgen-medium and
    codeqwen1.5-7b; in
    fp16 (the fp16 instantiations of ``flash_dense``) at head dims 64, 80,
    128 and 256 likewise, and fp32 on its two routes.

    The cases share one test instead of being parametrize items only while
    the reference's order-dependent ``test_shard_as_applies_constraint``
    stays unfixed (ROADMAP.md, faults): more items here move this file in
    pytest-xdist's loadfile queue, and that reference test then fails.
    """
    for case in ((1, 128, 2, 1, 128, 0, True),     # one q tile, one kv tile
                 (1, 129, 4, 2, 64, 0, True),      # one row past a tile
                 (1, 300, 4, 2, 128, 1, True),     # window 1: the row itself
                 (2, 400, 4, 1, 64, 127, True),    # window 127, a tile - 1
                 (1, 300, 4, 2, 80, 0, True),      # hd 80, GQA, ragged s
                 (2, 333, 4, 1, 80, 100, True),    # hd 80, windowed MQA
                 (1, 200, 4, 4, 80, 0, False),     # hd 80, non-causal
                 (2, 333, 10, 1, 256, 100, True),  # hd 256, windowed MQA
                 (1, 2100, 10, 1, 256, 2048, True),  # recurrentgemma's window
                 (1, 129, 2, 1, 256, 1, True),     # hd 256, window 1
                 (1, 300, 2, 2, 256, 63, True),    # window 63 < a kv tile
                 (1, 200, 2, 2, 256, 0, False),    # hd 256, non-causal
                 # the heads of granite-20b (MQA 48 / 1), internvl2-1b
                 # (GQA 14 / 2 at hd 64), musicgen-medium (MHA 24 / 24 at
                 # hd 64) and codeqwen1.5-7b (MHA 32 / 32 at hd 128)
                 (1, 300, 48, 1, 128, 0, True),
                 (2, 333, 14, 2, 64, 0, True),
                 (1, 300, 24, 24, 64, 0, True),
                 (1, 129, 32, 32, 128, 0, True)):
        _check_flash_dense(dev, case)
    # fp16 on the tensor cores (route "wgmma", the fp16 instantiation of
    # each tile shape): ragged s, windows narrower than a tile (1, 31, 63),
    # MQA and GQA, non-causal, recurrentgemma's window of 2048
    for case in ((1, 300, 4, 2, 64, 0, True), (2, 129, 4, 1, 64, 31, True),
                 (1, 333, 4, 1, 80, 63, True), (1, 200, 4, 4, 80, 0, False),
                 (1, 300, 4, 2, 128, 1, True), (2, 257, 8, 2, 128, 0, True),
                 (1, 96, 2, 1, 128, 0, False), (2, 333, 10, 1, 256, 100, True),
                 (1, 2100, 4, 1, 256, 2048, True),
                 (1, 200, 2, 2, 256, 0, False)):
        _check_flash_dense(dev, case, torch.float16)
    # fp32 on the tensor cores (route "tf32x3", head dims 64, 80 and 128,
    # and 8, 72, 96 and 120 computed at the widths 64, 80 and 128): s off
    # the 128-row q tiles and the 32- / 64-column kv tiles (s 1 too), MQA
    # and GQA, windows narrower than a kv tile, non-causal; on the cluster
    # pairs (route "tf32x3_256": head dim 256 with recurrentgemma's window
    # of 2048 and its 10 / 1 heads, windows narrower than a kv tile, 200
    # and 136, whose second CTA holds 72 and 8 real columns, non-causal,
    # s 1); then an odd head dim, copied to TMA's layout (hd 104)
    for case in ((1, 300, 4, 2, 64, 0, True), (2, 129, 4, 1, 80, 40, True),
                 (1, 300, 4, 2, 128, 1, True), (1, 65, 2, 2, 128, 0, False),
                 (1, 2100, 8, 2, 128, 0, True), (2, 333, 4, 1, 64, 31, True),
                 (2, 300, 8, 2, 72, 20, True), (1, 300, 4, 1, 96, 0, False),
                 (1, 1000, 4, 4, 80, 0, False), (2, 1, 4, 2, 128, 0, True),
                 (1, 37, 2, 1, 8, 0, True), (1, 300, 2, 1, 120, 20, True),
                 (1, 2100, 4, 1, 256, 2048, True),
                 (2, 333, 10, 1, 256, 100, True),
                 (1, 300, 2, 2, 256, 1, True), (2, 129, 4, 1, 200, 31, True),
                 (1, 200, 2, 2, 136, 0, False), (2, 1, 2, 1, 256, 0, True),
                 (2, 200, 4, 4, 100, 63, True)):
        _check_flash_dense(dev, case, torch.float32)


def _check_flash_dense(dev, case, dtype=torch.bfloat16):
    b, s, h, kvh, hd, window, causal = case
    q, k, v = (_randn(dev, b, s, n, hd, seed=i, dtype=dtype)
               for i, n in enumerate((h, kvh, kvh)))
    # the route of the head dim rounded up to 8: an odd one runs the
    # tensor-core kernel on copies in TMA's layout
    kernel = fa.FLASH_DENSE_BY_ROUTE[fa.flash_route(dtype,
                                                    fa.tma_head_dim(hd))]
    before = kernel.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert kernel.launches == before + 1
    want = fa.flash_attention_dense_plain(*fa.broadcast_flatten(q, k, v),
                                          causal=causal, window=window)
    _assert_close(out, want.reshape(b, h, s, hd).permute(0, 2, 1, 3),
                  SIMT_TOL[dtype][1])
    # block sizes name the TPU's blocking; the kernel's result ignores them
    assert torch.equal(flash_attention(q, k, v, causal=causal, window=window,
                                       block_q=128, block_k=64), out)


def test_flash_dense_reads_strided_heads(dev):
    """q, k and v as views of one (b, s, 3, h, hd) buffer: the heads are
    not contiguous rows, and the kernel reads them in place (hd 64, 128,
    and the padded 80 and 256); where TMA cannot describe them, the copy
    to TMA's layout (``tma_pack``) against its plain version.

    The cases share one test instead of being parametrize items only while
    the reference's order-dependent ``test_shard_as_applies_constraint``
    stays unfixed (ROADMAP.md, faults): more items here move this file in
    pytest-xdist's loadfile queue, and that reference test then fails.
    """
    b, s, h, kvh = 2, 300, 4, 2
    for hd in (64, 128, 80, 256):
        buf = _randn(dev, b, s, 3, h, hd, seed=5)
        q, k, v = buf[:, :, 0], buf[:, :, 1, :kvh], buf[:, :, 2, :kvh]
        assert not q.is_contiguous()
        out = flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_dense_plain(*fa.broadcast_flatten(q, k, v),
                                              causal=True)
        _assert_close(out, want.reshape(b, h, s, hd).permute(0, 2, 1, 3))
        assert torch.equal(flash_attention(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=True), out)
    # fp32: heads 16-byte multiples apart are read in place on the tensor
    # cores (the same bits as a contiguous copy), at 256 by the cluster
    # pairs; rows 130 floats apart are not TMA's, nor are odd head dims:
    # those calls copy q, k and v to TMA's layout and run the tensor-core
    # kernel of the copies' head dim (no general kernel)
    simt = fa.FLASH_DENSE_SIMT.launches
    for hd, width, kernel in ((128, 128, fa.FLASH_DENSE_F32),
                              (80, 80, fa.FLASH_DENSE_F32),
                              (256, 256, fa.FLASH_DENSE_F32_256),
                              (128, 130, fa.FLASH_DENSE_F32),
                              (100, 102, fa.FLASH_DENSE_F32),
                              (250, 252, fa.FLASH_DENSE_F32_256)):
        buf = _randn(dev, b, s, 3, h, width, seed=6, dtype=torch.float32)
        q, k, v = (buf[:, :, i, :n, :hd] for i, n in enumerate((h, kvh, kvh)))
        before = kernel.launches
        out = flash_attention(q, k, v, causal=True, window=50)
        assert kernel.launches == before + 1
        want = fa.flash_attention_dense_plain(*fa.broadcast_flatten(q, k, v),
                                              causal=True, window=50)
        _assert_close(out, want.reshape(b, h, s, hd).permute(0, 2, 1, 3),
                      SIMT_TOL[torch.float32][1])
        assert torch.equal(flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
            window=50), out)
    assert fa.FLASH_DENSE_SIMT.launches == simt
    # the copy itself (csrc/tma_pack.cu): q, k, v heads hd + 2 apart, a
    # base one element off 16 bytes, the head dim's stride not 1, and
    # contiguous at an odd head dim (loads of 2 to 16 bytes), every dtype,
    # odd and whole head dims, one launch for the three, bit for bit its
    # plain version
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for hd in (1, 20, 100, 128, 250, 256):
            buf = _randn(dev, b, s, 3, h, hd + 2, seed=hd, dtype=dt)
            flat = _randn(dev, 3 * b * s * h * hd + 1, seed=hd,
                          dtype=dt)[1:].view(3, b, s, h, hd)
            layouts = [[buf[:, :, i, :, :hd] for i in range(3)],
                       list(flat.unbind(0)),
                       list(_randn(dev, 3, b, s, hd, h, seed=hd, dtype=dt)
                            .transpose(3, 4).unbind(0))]
            if hd % 8:
                layouts.append([x.contiguous() for x in layouts[0]])
            for qkv in layouts:
                before = fa.TMA_PACK.launches
                got = fa._tma_pack(fa.tma_head_dim(hd), *qkv)
                assert fa.TMA_PACK.launches == before + 1
                want = fa.tma_pack_plain(fa.tma_head_dim(hd), *qkv)
                assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_flash_dense_bhsd_entry_and_errors(dev):
    q = _randn(dev, 3, 384, 128)
    out = fa.flash_attention_bhsd(q, q, q, window=100)
    _assert_close(out, fa.flash_attention_dense_plain(q, q, q, window=100))
    x = q[:, :, None]
    # fp32 runs the tensor-core kernel, a bf16 head dim of 84 flash_dense
    # on copies in TMA's layout (hd 88), never the general kernel
    simt = fa.FLASH_DENSE_SIMT.launches
    before = fa.FLASH_DENSE.launches, fa.FLASH_DENSE_F32.launches
    _assert_close(flash_attention(*(x.float(),) * 3, window=100),
                  fa.flash_attention_dense_plain(*(q.float(),) * 3,
                                                 window=100)[:, :, None],
                  SIMT_TOL[torch.float32][1])
    y = _randn(dev, 2, 200, 84)
    _assert_close(fa.flash_attention_bhsd(y, y, y),
                  fa.flash_attention_dense_plain(y, y, y))
    assert (fa.FLASH_DENSE.launches, fa.FLASH_DENSE_F32.launches) == (
        before[0] + 1, before[1] + 1)
    assert fa.FLASH_DENSE_SIMT.launches == simt
    # any head dim that is a multiple of 8 up to 256 (72: padded to 128)
    y = _randn(dev, 2, 200, 72)
    _assert_close(fa.flash_attention_bhsd(y, y, y),
                  fa.flash_attention_dense_plain(y, y, y))
    with pytest.raises(ValueError, match="head_dim"):
        y = _randn(dev, 1, 64, 1, 264)
        flash_attention(y, y, y)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        flash_attention(*(x.double(),) * 3)
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(x, x.cpu(), x)
    with pytest.raises(ValueError, match="GQA layout"):
        flash_attention(_randn(dev, 1, 64, 3, 64), *(_randn(dev, 1, 64, 2, 64),) * 2)


@pytest.mark.parametrize("shape", [(4, 256, 96, 256, 128), (6, 384, 64, 128, 128),
                                   (3, 256, 128, 128, 256)])
def test_gmm_matches_plain_and_is_schedule_free(dev, shape):
    _check_gmm(dev, shape)


def _check_gmm(dev, shape, dtype=torch.bfloat16, route=None, offset=0):
    """One forward call against the plain version, then bit-identical for
    every technique at sched_p 1, 3, 8 and the SM count; ``route``: the
    route the call must take; ``offset``: x a contiguous view ``offset``
    elements into its storage (a base off 16 bytes), whose output must
    also equal an aligned copy's bit for bit."""
    e, c, d, f, bm = shape
    if offset:
        x = _randn(dev, e * c * d + offset, seed=1,
                   dtype=dtype)[offset:].view(e, c, d)
    else:
        x = _randn(dev, e, c, d, seed=1, dtype=dtype)
    w = _randn(dev, e, d, f, seed=2, scale=max(d, 1) ** -0.5, dtype=dtype)
    rows = np.random.default_rng(e).integers(0, c + 1, size=e)
    got_route = gm.gmm_route(dtype, dtype, bm, d, f, gm._aligned(x, w))
    assert route is None or got_route == route, (shape, dtype, got_route)
    kernel = gm.GMM_BY_ROUTE[got_route]
    before = kernel.launches
    out = grouped_matmul(x, w, block_rows=bm, schedule="fac2",
                         expert_rows=rows, sched_p=3)
    assert kernel.launches == before + 1 and out.dtype == dtype
    t = e * (c // bm)
    te = torch.arange(t, device=dev) // (c // bm)
    want = gm.grouped_matmul_tiles_plain(x.reshape(t, bm, d), w, te)
    _assert_close(out, want.reshape(e, c, f), SIMT_TOL[dtype][0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for tech in REGISTRY:
        for p in (8, n_sm):
            assert torch.equal(grouped_matmul(x, w, block_rows=bm, schedule=tech,
                                              expert_rows=rows, sched_p=p), out)
    assert torch.equal(grouped_matmul(x, w, block_rows=bm), out)
    assert torch.equal(grouped_matmul(x, w, block_rows=bm, sched_p=1), out)
    perm = np.random.default_rng(0).permutation(t)
    assert torch.equal(grouped_matmul(x, w, tile_order=perm, block_rows=bm), out)
    if offset:
        assert torch.equal(grouped_matmul(x.clone(), w, block_rows=bm), out)


def _moe_case(dev, **kw):
    """(cfg, params, x) of a small MoE FFN: 8 experts, d 256, expert d_ff
    256, top-2, ragged dispatch, bf16; 2 x 300 tokens in 2 groups give
    ``cap`` 96 and 192 rows an expert, padded to 256 for the kernel."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.moe import init_moe

    base = get_arch("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(
        base, d_model=256, compute_dtype="bfloat16", moe=dataclasses.replace(
            base.moe, num_experts=8, top_k=2, d_ff=256, dispatch="ragged"))
    cfg = dataclasses.replace(cfg, **kw)
    params, _ = init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    return cfg, params, _randn(dev, 2, 300, cfg.d_model, seed=6)


def _plain_grouped_matmul(xe, w, *, block_rows, **_):
    """``grouped_matmul``'s identity-order product on the plain version."""
    e, r, d = xe.shape
    tiles = r // block_rows
    te = torch.arange(e * tiles, device=xe.device) // tiles
    return gm.grouped_matmul_tiles_plain(
        xe.reshape(e * tiles, block_rows, d), w, te).reshape(e, r, -1)


def _check_moe_ragged(dev, monkeypatch):
    """``moe_ragged`` on CUDA tensors: one ``gmm`` launch per projection,
    each with one CTA per SM, against the same call with the plain version
    in place of ``grouped_matmul``; two runs bit-identical."""
    from repro_torch.kernels.grouped_matmul import ops
    from repro_torch.models import moe as tmoe

    cfg, params, x = _moe_case(dev)
    assert tmoe._capacity(cfg, 300) % 128
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas = []
    real = ops.gmm_cuda

    def spy(x_tiles, w, te, order, bounds, n_span):
        ctas.append(len(bounds) - 1)
        return real(x_tiles, w, te, order, bounds, n_span)

    monkeypatch.setattr(ops, "gmm_cuda", spy)
    before = gm.GMM.launches
    y, _, load = tmoe.moe_ragged(params, cfg, x)
    assert gm.GMM.launches == before + 3 and ctas == [n_sm] * 3
    assert torch.equal(tmoe.moe_ragged(params, cfg, x)[0], y)
    monkeypatch.setattr(tmoe, "grouped_matmul", _plain_grouped_matmul)
    want, _, want_load = tmoe.moe_ragged(params, cfg, x)
    assert gm.GMM.launches == before + 6
    _assert_close(y, want)
    assert torch.equal(load, want_load)


def test_gmm_tails_and_one_cta_ring(dev, monkeypatch):
    """The d tail, the 128-column tail and a single tile, then sched_p = 1:
    one CTA walks every unit, so its stage ring wraps many times and its
    phase bits carry on across units and tiles.  Last, the MoE model's
    ragged dispatch, whose expert rows are padded to the 128-row tile.

    The cases share one test instead of being parametrize items only while
    the reference's order-dependent ``test_shard_as_applies_constraint``
    stays unfixed (ROADMAP.md, faults): more items here move this file in
    pytest-xdist's loadfile queue, and that reference test then fails.
    """
    # the last 64-deep box runs past d = 160; f = 384 is a 256 block and a
    # 128 tail
    _check_gmm(dev, (2, 256, 160, 384, 128))
    _check_gmm(dev, (1, 128, 64, 128, 128))   # one expert, a single tile
    # off gmm.cu's blocks: the reference MoE demo's fp32 call (bm 8, d 64,
    # f 32), bf16 at that shape, the qwen3-moe width in 8-row tiles, and
    # ragged widths in fp32 and fp16.  bf16 / fp16 with d and f multiples
    # of 8 take gmm_any on TMA (runs of 8-row tiles stacked up to 128 rows;
    # bm 64; d and f tails inside a 64-wide box; a 264-column f whose last
    # block is an n64; bm 5, one tile a unit; bm 200, two row blocks); f 36
    # takes its thread loader.  fp32: runs of 24-row tiles, bm 200, and
    # d 30 / f 34, whose rows take 4-byte copies
    for shape, dt in (((4, 16, 64, 32, 8), torch.float32),
                      ((4, 16, 64, 32, 8), torch.bfloat16),
                      ((3, 32, 2048, 768, 8), torch.float32),
                      ((3, 64, 2048, 768, 8), torch.bfloat16),
                      ((2, 256, 100, 200, 128), torch.float32),
                      ((3, 96, 40, 72, 24), torch.float16),
                      ((3, 96, 40, 72, 24), torch.float32),
                      ((3, 128, 200, 72, 64), torch.bfloat16),
                      ((2, 128, 136, 264, 64), torch.float16),
                      ((4, 64, 72, 40, 8), torch.float16),
                      ((2, 40, 64, 40, 5), torch.bfloat16),
                      ((2, 200, 64, 128, 200), torch.bfloat16),
                      ((2, 200, 64, 96, 200), torch.float32),
                      ((2, 16, 30, 34, 8), torch.float32),
                      ((2, 32, 64, 36, 8), torch.bfloat16)):
        _check_gmm(dev, shape, dt)
    # the thread loader (route "wgmma_ld"): f 764 (8-byte copies of w) in
    # bf16 and fp16, d 2044 (8-byte copies of both), f 36 in fp16, an odd
    # f (2-byte loads through registers, 2-byte stores), bm 5 and 24
    # stacked into runs, d 0 (zeros), and bases 2 and 8 bytes off 16
    # (register path, 8-byte copies), each equal to an aligned copy's
    # output on TMA
    for shape, dt, offset in (((4, 64, 2048, 764, 8), torch.bfloat16, 0),
                              ((4, 64, 2048, 764, 8), torch.float16, 0),
                              ((3, 64, 2044, 768, 8), torch.float16, 0),
                              ((2, 32, 64, 36, 8), torch.float16, 0),
                              ((3, 40, 72, 33, 8), torch.bfloat16, 0),
                              ((3, 40, 100, 129, 5), torch.float16, 0),
                              ((3, 96, 30, 70, 24), torch.bfloat16, 0),
                              ((2, 16, 0, 40, 8), torch.bfloat16, 0),
                              ((3, 64, 2048, 768, 8), torch.bfloat16, 1),
                              ((2, 128, 72, 136, 64), torch.float16, 4)):
        _check_gmm(dev, shape, dt, route="wgmma_ld", offset=offset)
    e, c, d, f, bm = 4, 512, 256, 512, 128
    x = _randn(dev, e, c, d, seed=3)
    w = _randn(dev, e, d, f, seed=4, scale=d ** -0.5)
    out = grouped_matmul(x, w, block_rows=bm, sched_p=1)
    t = e * (c // bm)
    te = torch.arange(t, device=dev) // (c // bm)
    want = gm.grouped_matmul_tiles_plain(x.reshape(t, bm, d), w, te)
    _assert_close(out, want.reshape(e, c, f))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert torch.equal(grouped_matmul(x, w, block_rows=bm, sched_p=n_sm), out)
    rows = np.array([512, 3, 0, 200])
    assert torch.equal(grouped_matmul(x, w, block_rows=bm, schedule="fac2",
                                      expert_rows=rows, sched_p=1), out)
    _check_moe_ragged(dev, monkeypatch)


def test_gmm_rejects_what_the_kernel_does_not_take(dev, monkeypatch):
    """What the wgmma kernel does not take runs another kernel, also
    through the MoE model's ragged dispatch: fp32 tensors on ``gmm_simt``
    and an expert d_ff that is not a multiple of 128 on ``gmm_any``, one
    launch a projection, against the same call on the plain version.  What
    no kernel takes raises; nothing falls back to the einsum."""
    import dataclasses

    from repro_torch.models import moe as tmoe

    x = _randn(dev, 2, 128, 64)
    w96 = _randn(dev, 2, 64, 96)
    before = gm.GMM_ANY.launches
    _assert_close(grouped_matmul(x, w96, block_rows=128),
                  _plain_grouped_matmul(x, w96, block_rows=128))
    assert gm.GMM_ANY.launches == before + 1
    with pytest.raises(TypeError, match="gmm takes"):
        grouped_matmul(x.float(), _randn(dev, 2, 64, 128), block_rows=128)
    with pytest.raises(TypeError, match="gmm takes"):
        grouped_matmul(x.double(), w96.double(), block_rows=128)
    with pytest.raises(ValueError, match="contiguous"):
        gm.gmm_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), w96,
                    torch.zeros(2, dtype=torch.int32, device=dev),
                    [0, 1], gm.span_bounds(2, 2), 2)
    cfg, params, xm = _moe_case(dev)
    cfg96 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             d_ff=96))
    params96 = {k: (v[..., :96] if k in ("wi", "wg") else
                    v[:, :96] if k == "wo" else v) for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    # (simt, any, wgmma) launches: at d_ff 96, wo (d 96, f 256) fits gmm.cu
    kernels = (gm.GMM_SIMT, gm.GMM_ANY, gm.GMM)
    for c, p, xx, dt, n in ((cfg32, params, xm.float(), torch.float32,
                             (3, 0, 0)),
                            (cfg96, params96, xm, torch.bfloat16, (0, 2, 1))):
        before = [k.launches for k in kernels]
        y = tmoe.moe_ragged(p, c, xx)[0]
        assert tuple(k.launches - b for k, b in zip(kernels, before)) == n
        assert y.dtype == dt
        with monkeypatch.context() as m:
            m.setattr(tmoe, "grouped_matmul", _plain_grouped_matmul)
            want = tmoe.moe_ragged(p, c, xx)[0]
        _assert_close(y, want, SIMT_TOL[dt][0] if dt == torch.bfloat16
                      else 1e-4)


def test_build_is_cached_and_counted(dev):
    libs = _build.build_all()
    assert set(libs) == {"flash_dense", "flash_dense_bwd", "flash_sched",
                         "gmm", "gmm_any", "gmm_simt", "flash_simt",
                         "flash_simt_bwd", "flash_f32", "flash_f32_bwd",
                         "tma_pack"}
    assert all(p.is_file() for p in libs.values())
    _build.reset_launches()
    assert all(k.launches == 0 for k in _build.KERNELS.values())


def test_forward_launches_flash_dense_once_per_layer(dev):
    """A 2-layer full-width qwen3-4b prefill above the flash threshold goes
    through the dense kernel once per layer."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import forward, init_decoder

    cfg = dataclasses.replace(get_arch("qwen3-4b"), num_layers=2)
    params, _ = init_decoder(0, cfg, device=dev)
    s = cfg.flash_threshold + 52
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, s))).to(dev)
    before = fa.FLASH_DENSE.launches
    logits, _ = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    assert fa.FLASH_DENSE.launches == before + cfg.num_layers
    assert logits.shape == (1, s, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
