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
card.  The kernels themselves are held to their plain versions on the
card (``tests/test_torch_cuda_kernels.py``,
``tests/test_torch_cuda_train.py``).
"""

import pytest
import torch

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
    assert fa.FLASH_DENSE_BY_ROUTE == {
        "wgmma": fa.FLASH_DENSE, "tf32x3": fa.FLASH_DENSE_F32,
        "tf32x3_256": fa.FLASH_DENSE_F32_256, "simt": fa.FLASH_DENSE_SIMT}
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
