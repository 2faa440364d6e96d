"""Which hand-written kernel takes a call, decided on the CPU from the
dtype and the shape alone: the routing functions of the grouped matmul
and of the flash kernels (``gmm_route`` / ``gmm_dx_route`` /
``gmm_dw_route``, ``flash_route`` and ``_check_kernel_inputs``).

bf16 at the wgmma kernels' blocks goes to them ("wgmma"), so does an fp16
flash call of either entry, and an fp32 flash call up to head dim 128 with
strides TMA can describe to the fp32 tensor-core kernels ("tf32x3"), at
136-256 to their cluster pairs ("tf32x3_256": the dense forward and the
backward; the schedule-aware entry's table names the general kernel
there); every other
bf16 and fp16 call of the grouped matmul family goes to ``gmm_any`` / ``gmm_dx_any`` /
``gmm_dw_any``, fed by TMA where TMA can describe the rows (d and f
multiples of 8, 16-byte aligned data: "wgmma_any") and by the producer
warpgroup's copies otherwise ("wgmma_ld"); the rest of fp32 goes to the
general kernels ("simt"); what none takes raises, on the CPU as on the
card.  A dense flash call of route "simt" (a head dim or strides TMA
cannot describe), forward and backward, runs the tensor-core route of
its copies in TMA's layout (``_tma_pack``) at the softmax scale of its
real head dim.  The kernels themselves are held to their plain versions on the
card (``tests/test_torch_cuda_kernels.py``,
``tests/test_torch_cuda_train.py``).
"""

import ctypes
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.grouped_matmul import grouped_matmul as gm

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


def test_gmm_routes_by_dtype_and_shape():
    # the aligned bf16 shapes of gmm.cu's blocks: bm, f % 128, d % 32
    assert gm.gmm_route(BF16, BF16, 128, 2048, 768) == "wgmma"
    assert gm.gmm_route(BF16, BF16, 256, 160, 384) == "wgmma"
    assert gm.gmm_route(BF16, BF16, 128, 96, 128, aligned=False) == "wgmma_ld"
    # the reference MoE demo's call and the qwen3-moe width in 8-row tiles:
    # 2-byte rows TMA can describe go to gmm_any, fp32 to gmm_simt
    for dt in (BF16, F16):
        assert gm.gmm_route(dt, dt, 8, 64, 32) == "wgmma_any"
        assert gm.gmm_route(dt, dt, 8, 2048, 768) == "wgmma_any"
    assert gm.gmm_route(F32, F32, 8, 64, 32) == "simt"
    assert gm.gmm_route(F32, F32, 8, 2048, 768) == "simt"
    for shape in ((128, 2048, 96), (64, 128, 128), (5, 40, 64),
                  (200, 64, 128), (128, 128, 8)):
        assert gm.gmm_route(BF16, BF16, *shape) == "wgmma_any"
        assert gm.gmm_route(F16, F16, *shape) == "wgmma_any"
        assert gm.gmm_route(F32, F32, *shape) == "simt"
    # fp16 at gmm.cu's blocks: gmm.cu is bf16 only
    assert gm.gmm_route(F16, F16, 128, 2048, 768) == "wgmma_any"
    assert gm.gmm_route(F32, F32, 128, 2048, 768) == "simt"
    # the edges of TMA's rows: d or f off 8, d 0, a misaligned base; the
    # thread loader takes them
    for shape in ((128, 100, 128), (8, 2048, 764), (8, 2044, 768),
                  (8, 2048, 4), (64, 0, 128)):
        assert gm.gmm_route(BF16, BF16, *shape) == "wgmma_ld"
        assert gm.gmm_route(F16, F16, *shape) == "wgmma_ld"
        assert gm.gmm_route(F32, F32, *shape) == "simt"
    assert gm.gmm_route(BF16, BF16, 8, 2048, 768, aligned=False) == "wgmma_ld"
    assert gm.gmm_route(F16, F16, 8, 64, 32, aligned=False) == "wgmma_ld"
    for pair in ((F32, BF16), (torch.float64, torch.float64),
                 (torch.int32, torch.int32)):
        with pytest.raises(TypeError, match="gmm takes"):
            gm.gmm_route(*pair, 128, 128, 128)


def test_gmm_backward_routes_by_dtype_and_shape():
    # gmm_dx: R and d % 128, f % 32; gmm_dw: d and f % 128, R > 0
    assert gm.gmm_dx_route(BF16, BF16, 640, 2048, 768) == "wgmma"
    assert gm.gmm_dw_route(BF16, BF16, 640, 2048, 768) == "wgmma"
    assert gm.gmm_dx_route(BF16, BF16, 128, 128, 224) == "wgmma"
    assert gm.gmm_dw_route(BF16, BF16, 128, 128, 224) == "wgmma_any"
    # rows TMA cannot describe, or R 0: the thread loader
    for r, d, f in ((640, 2048, 100), (0, 128, 128), (64, 2044, 768)):
        assert gm.gmm_dx_route(BF16, BF16, r, d, f) == "wgmma_ld"
        assert gm.gmm_dw_route(BF16, BF16, r, d, f) == "wgmma_ld"
    # off gmm_dx's and gmm_dw's blocks with rows TMA can describe:
    # gmm_dx_any and gmm_dw_any on TMA
    for r, d, f in ((8, 64, 32), (64, 2048, 768), (100, 200, 72)):
        for dt in (BF16, F16):
            assert gm.gmm_dx_route(dt, dt, r, d, f) == "wgmma_any"
            assert gm.gmm_dx_route(dt, dt, r, d, f, aligned=False) == \
                "wgmma_ld"
        assert gm.gmm_dx_route(F32, F32, r, d, f) == "simt"
    assert gm.gmm_dw_route(BF16, BF16, 8, 64, 32) == "wgmma_any"
    # rows that are no multiple of 128: dX's m tiles, dW's zero-filled depth
    assert gm.gmm_dx_route(BF16, BF16, 100, 256, 256) == "wgmma_any"
    assert gm.gmm_dw_route(BF16, BF16, 100, 256, 256) == "wgmma"
    assert gm.gmm_dx_route(F16, F16, 640, 2048, 768) == "wgmma_any"
    assert gm.gmm_dx_route(F32, F32, 640, 2048, 768) == "simt"
    assert gm.gmm_dw_route(F16, F16, 640, 2048, 768) == "wgmma_any"
    assert gm.gmm_dw_route(F32, F32, 640, 2048, 768) == "simt"
    with pytest.raises(TypeError, match="gmm_dx takes"):
        gm.gmm_dx_route(F32, BF16, 128, 128, 128)
    with pytest.raises(TypeError, match="gmm_dw takes"):
        gm.gmm_dw_route(torch.float64, torch.float64, 128, 128, 128)


def test_every_2byte_gmm_call_takes_a_wgmma_route():
    """Every bf16 and fp16 call of the three products, at widths 1-300 on
    either side, rows 1, 8 and 300 (and 0 for dX and dW) and either
    alignment, gets a wgmma
    route, TMA's exactly where it can describe the rows; every fp32 call
    gets "simt"; an empty side (d, f or R 0) takes the thread loader."""
    routes = (gm.gmm_route, gm.gmm_dx_route, gm.gmm_dw_route)
    n = 0
    for dt in (BF16, F16, F32):
        for aligned in (True, False):
            for w in range(0, 301):
                for o in (1, 8, 36, 764, 768):
                    for d, f in ((w, o), (o, w)):
                        tma = aligned and d % 8 == 0 and f % 8 == 0 \
                            and d > 0 and f > 0
                        for rows in (0, 1, 8, 300):
                            for route_fn in routes:
                                if rows == 0 and route_fn is gm.gmm_route:
                                    continue
                                got = route_fn(dt, dt, rows, d, f, aligned)
                                n += 1
                                if dt == F32:
                                    assert got == "simt"
                                elif rows > 0 and tma:
                                    assert got in ("wgmma", "wgmma_any")
                                    assert got == "wgmma_any" or dt == BF16
                                else:
                                    assert got == "wgmma_ld", (
                                        route_fn.__name__, dt, rows, d, f,
                                        aligned)
    assert n == 3 * 2 * 301 * 5 * 2 * 11


def test_flash_routes_by_dtype_head_dim_and_strides():
    for hd in range(8, 257, 8):
        # bf16 and fp16 on the tensor cores, both entries and the backward
        assert fa.flash_route(BF16, hd) == "wgmma"
        assert fa.flash_route(F16, hd) == "wgmma"
        # fp32 on the tensor cores: up to 128 (three TF32 products each),
        # 136-256 on cluster pairs
        assert fa.flash_route(F32, hd) == (
            "tf32x3" if hd <= 128 else "tf32x3_256")
        for dt in (BF16, F16, F32):
            assert fa.flash_route(dt, hd, tma_ok=False) == "simt"
    for hd in (64, 80, 96, 128):
        assert fa.flash_route(F32, hd) == "tf32x3"
    for hd in (136, 200, 256):
        assert fa.flash_route(F32, hd) == "tf32x3_256"
    for hd in (1, 20, 100, 250):
        assert fa.flash_route(BF16, hd) == "simt"
        assert fa.flash_route(F16, hd) == "simt"
        assert fa.flash_route(F32, hd) == "simt"
    # each entry's kernel of a route: the schedule-aware fp32 call at
    # 136-256 on the general kernel, the dense one on the cluster pairs
    assert fa.FLASH_SCHED_BY_ROUTE == {
        "wgmma": fa.FLASH_SCHED, "tf32x3": fa.FLASH_SCHED_F32,
        "tf32x3_256": fa.FLASH_SCHED_SIMT, "simt": fa.FLASH_SCHED_SIMT}
    # the dense entry has no kernel of route "simt": such a call runs the
    # route of its copies in TMA's layout, at the head dim rounded up to 8
    assert fa.FLASH_DENSE_BY_ROUTE == {
        "wgmma": fa.FLASH_DENSE, "tf32x3": fa.FLASH_DENSE_F32,
        "tf32x3_256": fa.FLASH_DENSE_F32_256}
    assert [fa.tma_head_dim(hd) for hd in (1, 7, 8, 9, 20, 100, 121, 129,
                                           250, 256)] == [
        8, 8, 8, 16, 24, 104, 128, 136, 256, 256]
    assert fa.FLASH_F32_BWD_BY_ROUTE == {
        "tf32x3": (fa.FLASH_F32_BWD_DKDV, fa.FLASH_F32_BWD_DQ),
        "tf32x3_256": (fa.FLASH_F32_BWD256_DKDV, fa.FLASH_F32_BWD256_DQ)}
    for hd in (0, 264, 512):
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_route(F32, hd)
    for dt in (torch.float64, torch.int32):
        with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
            fa.flash_route(dt, 128)


def test_flash_kernel_check_reads_layout_and_strides():
    q = torch.zeros(1, 16, 4, 128, dtype=BF16)
    kv = torch.zeros(1, 16, 2, 128, dtype=BF16)
    assert fa._check_kernel_inputs("flash_dense", q, kv, kv) == "wgmma"
    q32, kv32 = q.float(), kv.float()
    assert fa._check_kernel_inputs("flash_dense", q32, kv32,
                                   kv32) == "tf32x3"
    # the schedule-aware entry takes fp32 on the tensor cores
    assert fa.FLASH_SCHED_BY_ROUTE[fa._check_kernel_inputs(
        "flash_sched", q32, kv32, kv32)] is fa.FLASH_SCHED_F32
    # a head dim the TMA boxes cannot step (strides not multiples of 8)
    odd = torch.zeros(1, 16, 4, 132, dtype=BF16)[..., :128]
    assert fa._check_kernel_inputs("flash_dense", odd, kv, kv) == "simt"
    # fp32 rows 528 bytes apart are whole 16-byte steps; 520 are not
    assert fa._check_kernel_inputs("flash_dense", odd.float(), kv32,
                                   kv32) == "tf32x3"
    odd32 = torch.zeros(1, 16, 4, 130)[..., :128]
    assert fa._check_kernel_inputs("flash_dense", odd32, kv32, kv32) == "simt"
    # fp32 past head dim 128 on the cluster pairs where TMA can describe
    # the strides (rows 1032 bytes apart: it cannot), the schedule-aware
    # entry there on the general kernel
    wide = torch.zeros(1, 16, 2, 256)
    assert fa._check_kernel_inputs("flash_dense", wide, wide,
                                   wide) == "tf32x3_256"
    assert fa.FLASH_SCHED_BY_ROUTE[fa._check_kernel_inputs(
        "flash_sched", wide, wide, wide)] is fa.FLASH_SCHED_SIMT
    odd256 = torch.zeros(1, 16, 2, 258)[..., :256]
    assert fa._check_kernel_inputs("flash_dense", odd256, wide,
                                   wide) == "simt"
    # fp16: both entries on the tensor cores; an odd head dim and rows TMA
    # cannot step on the general kernels
    assert fa._check_kernel_inputs("flash_dense", q.half(), kv.half(),
                                   kv.half()) == "wgmma"
    assert fa.FLASH_SCHED_BY_ROUTE[fa._check_kernel_inputs(
        "flash_sched", q.half(), kv.half(), kv.half())] is fa.FLASH_SCHED
    odd16 = torch.zeros(1, 16, 4, 132, dtype=F16)[..., :128]
    assert fa._check_kernel_inputs("flash_dense", odd16, kv.half(),
                                   kv.half()) == "simt"
    q100 = torch.zeros(1, 16, 2, 100, dtype=F16)
    assert fa._check_kernel_inputs("flash_dense", q100, q100, q100) == "simt"
    # the fp16 backward, on either route, takes the forward's rounding
    # residual o_lo and no other dtype takes one: refused before any launch
    for qkv, o_lo in (((q.half(), kv.half(), kv.half()), None),
                      ((q100, q100, q100), None), ((q, kv, kv), q),
                      ((q32, kv32, kv32), q32)):
        with pytest.raises(ValueError, match="o_lo"):
            fa._flash_dense_bwd_cuda(*qkv, qkv[0], qkv[0], None, o_lo,
                                     causal=True, window=0)
    with pytest.raises(TypeError, match="one dtype"):
        fa._check_kernel_inputs("flash_dense", q, kv.float(), kv)
    with pytest.raises(ValueError, match="GQA layout"):
        fa._check_kernel_inputs("flash_dense", torch.zeros(1, 16, 3, 128),
                                kv.float(), kv.float())


def _layouts(dt, hd, gen):
    """q, k, v (b, s, h, hd) in the layouts the dense entry may be given:
    contiguous, heads hd + 2 apart, a base one element off, and GQA / MQA
    k and v (each with heads hd + 2 apart where hd % 8 == 0, so that every
    case but the contiguous ones needs a copy)."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dt)

    b, s, h = 1, 3, 4
    buf = rnd(b, s, 3 * h, hd + 2)
    flat = rnd(3 * b * s * h * hd + 1)[1:]
    off = [flat[i * b * s * h * hd:(i + 1) * b * s * h * hd].view(b, s, h, hd)
           for i in range(3)]
    yield "contiguous", rnd(b, s, h, hd), rnd(b, s, h, hd), rnd(b, s, h, hd)
    yield "head stride hd + 2", *(buf[:, :, i * h:(i + 1) * h, :hd]
                                  for i in range(3))
    yield "base one element off", *off
    for kvh in (2, 1):
        yield f"kv heads {kvh}", rnd(b, s, h, hd), *(
            buf[:, :, i * h:i * h + kvh, :hd] for i in (1, 2))


def _emulate_tma_pack(self, table, n, hd_pad, elem_bytes, stream):
    """What ``csrc/tma_pack.cu`` does with its launch table, on host
    memory: each row (source, destination, b, s, heads, hd, four strides
    in elements) copied through its strides, zeros past hd."""
    rows = np.ctypeslib.as_array(
        (ctypes.c_longlong * (fa.TMA_PACK_FIELDS * n)).from_address(table))
    word = {2: ctypes.c_uint16, 4: ctypes.c_uint32}[elem_bytes]
    for src, dst, b, s, h, hd, *st in rows.reshape(n, -1).tolist():
        span = 1 + sum((d - 1) * x for d, x in zip((b, s, h, hd), st))
        mem = np.ctypeslib.as_array(ctypes.cast(src, ctypes.POINTER(word)),
                                    shape=(span,))
        out = np.ctypeslib.as_array(ctypes.cast(dst, ctypes.POINTER(word)),
                                    shape=(b, s, h, hd_pad))
        out[...] = 0
        out[..., :hd] = np.lib.stride_tricks.as_strided(
            mem, (b, s, h, hd), [x * elem_bytes for x in st])


def test_tma_pack_makes_every_dense_layout_tma_ready(monkeypatch):
    """For float32, bfloat16 and float16, every head dim 1-256 and each
    layout of ``_layouts``: the copy to TMA's layout is one ``_tma_ok``
    accepts at the head dim rounded up to 8, equal to the input before
    ``hd`` and zero past it, and the input itself where nothing needed
    copying; the dense entry's route after it is never "simt" and is
    ``flash_route(dtype, hd_pad)``.  The ``tma_pack`` launch's table,
    read as the kernel reads it (``_emulate_tma_pack``), gives the same
    bits for all of a call's tensors in one launch."""
    monkeypatch.setattr(_build.Kernel, "launch", _emulate_tma_pack)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    gen = torch.Generator().manual_seed(0)
    n = 0
    for dt in (F32, BF16, F16):
        for hd in range(1, 257):
            hd_pad = fa.tma_head_dim(hd)
            for name, *qkv in _layouts(dt, hd, gen):
                packed = fa._tma_pack(hd_pad, *qkv)
                for x, y in zip(qkv, packed):
                    same = hd % 8 == 0 and fa._tma_ok(x)
                    assert (y is x) == same, (dt, hd, name)
                    assert fa._tma_ok(y) and y.shape == (*x.shape[:3], hd_pad)
                    assert y.dtype == dt and torch.equal(y[..., :hd], x)
                    assert not y[..., hd:].any()
                    assert same or y.is_contiguous()
                route = fa._check_kernel_inputs("flash_dense", *packed)
                assert route == fa.flash_route(dt, hd_pad) != "simt"
                pairs = [(x, y) for x, y in zip(qkv, packed) if y is not x]
                if pairs:
                    launched = [torch.full_like(y, 7) for _, y in pairs]
                    fa._tma_pack_launch(hd_pad, [x for x, _ in pairs],
                                        launched)
                    assert all(torch.equal(a, y) for a, (_, y) in
                               zip(launched, pairs))
                assert (fa._check_kernel_inputs("flash_dense", *qkv)
                        == "simt") == (hd % 8 > 0 or name != "contiguous")
                n += 1
    assert n == 3 * 256 * 5


def test_dense_launches_carry_the_real_head_dims_scale(monkeypatch):
    """The dense entry's launches on CPU tensors, recorded instead of
    run: at odd head dims and on views TMA cannot describe, the forward
    and the three backward passes launch the packed route's kernels once
    each on 16-byte aligned data, never a general kernel but the fp32
    delta pass, with the softmax scale 1 / sqrt(hd), not 1 / sqrt(hd_pad);
    the outputs come back at hd."""
    calls = []
    monkeypatch.setattr(_build.Kernel, "launch",
                        lambda self, *args: calls.append((self, args)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    gen = torch.Generator().manual_seed(1)
    for dt in (F32, BF16, F16):
        for hd in (1, 20, 64, 100, 121, 130, 250, 256):
            hd_pad = fa.tma_head_dim(hd)
            route = fa.flash_route(dt, hd_pad)
            want = ([fa.FLASH_DENSE, fa.FLASH_DENSE_BWD_DELTA,
                     fa.FLASH_DENSE_BWD_DKDV, fa.FLASH_DENSE_BWD_DQ]
                    if route == "wgmma" else
                    [fa.FLASH_DENSE_BY_ROUTE[route], fa.FLASH_SIMT_BWD_DELTA,
                     *fa.FLASH_F32_BWD_BY_ROUTE[route]])
            for name, q, k, v in _layouts(dt, hd, gen):
                if name == "contiguous" and hd % 8 == 0:
                    continue
                calls.clear()
                out, lse, o_lo = fa._flash_dense_cuda(
                    q, k, v, causal=True, window=0, with_lse=True)
                do = torch.randn(q.shape, generator=gen).to(dt)
                grads = fa._flash_dense_bwd_cuda(q, k, v, out, do, lse, o_lo,
                                                 causal=True, window=0)
                assert [c[0] for c in calls] == want, (dt, hd, name)
                assert out.shape == q.shape and lse.shape == (1, 4, 3)
                assert (o_lo is None) == (dt != F16)
                assert o_lo is None or o_lo.shape[3] == hd_pad
                assert [g.shape for g in grads] == [x.shape for x in (q, k, v)]
                # the first pointer of each pass (q, or o for a delta pass)
                assert all(args[0] % 16 == 0 for _, args in calls)
                scales = [a for kern, args in calls
                          for a, t in zip(args, kern.argtypes)
                          if t is ctypes.c_float]
                assert scales == [1.0 / math.sqrt(hd)] * 3, (dt, hd, scales)
