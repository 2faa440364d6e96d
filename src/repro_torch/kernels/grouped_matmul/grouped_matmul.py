"""Grouped (expert-tile) matmul with a DLS-planned work list: the kernel and
its plain version.

Port of ``src/repro/kernels/grouped_matmul/grouped_matmul.py``.  The MoE
expert FFN is a ragged batch of matmuls: expert e owns rows[e] tokens.  The
work list is a 1-D list of row tiles, each multiplied by its expert's
(d, f) weight; the tile order comes from the DLS planner
(``repro_torch.balance.moe.plan_tiles``), so that a split of the list
across ``p`` workers gives each near-equal work.

On a CUDA tensor the list drives ``csrc/gmm.cu``: a persistent kernel with
``p`` CTAs, CTA ``w`` walking its plan share in order and then its
round-robin part of the dead tiles, fed by TMA and computed with wgmma;
see the note at the top of that file.  That kernel takes bf16 with rows,
columns and depth in whole blocks.  bf16 and fp16 at any other shape run
``csrc/gmm_any.cu`` (``gmm_any``): the same walk and wgmma, a unit stacking
the run of consecutive steps whose tiles share an expert, so that the
expert's weights are read once per run, its stages filled by TMA where TMA
can describe the rows (``d`` and ``f`` multiples of 8, 16-byte aligned
data) and by the producer warpgroup's own copies otherwise.  fp32 runs
``csrc/gmm_simt.cu`` (``gmm_simt``), a register-blocked SGEMM on the CUDA
cores over the same runs.  ``gmm_route`` picks the kernel and the loader
from the dtype and the shape alone.  On a CPU tensor
``grouped_matmul_tiles_plain`` computes the same function.  Tiles are
independent, so the output is bit-identical for every order.

The backward of the expert-row product Y[e] = X[e] W[e] (no Pallas kernel:
the reference differentiates its einsums by autodiff), for training the
ragged MoE: ``grouped_matmul_bwd`` computes dX = dY W^T with ``gmm_dx`` and
dW[e] = X[e]^T dY[e] with ``gmm_dw`` (both in ``csrc/gmm.cu``, persistent,
no split-k, no atomics).  dX needs no plan, so ``gmm_dx`` walks an
expert-major raster: the 128-row tiles that share one (expert, 256-column)
weight panel run at once on neighbouring CTAs, which read the panel from
device memory once and from L2 after that, the weights read K-major in
place.  ``gmm_dw`` runs one CTA per (expert, dW tile) at a time, the rows
summed in ascending order.  ``gmm_dx_any`` and ``gmm_dw_any``
(``csrc/gmm_any.cu``) take bf16 and fp16 off those blocks, with either
loader, and ``gmm_dx_simt`` and ``gmm_dw_simt`` (``csrc/gmm_simt.cu``)
fp32, as for the forward.  On a CPU tensor ``grouped_matmul_bwd_plain``
computes both.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import check_device
from .._build import SIMT_DTYPES, Kernel
from .ref import grouped_matmul_ref

#: what the wgmma kernels take: rows and output widths multiples of their
#: 128-row, 128-column output blocks (256 columns where the width allows),
#: the reduction depth a multiple of 32 (64-deep stages are zero-filled
#: past it); gmm: block_rows, f and d; gmm_dx: R, d and f
KERNEL_BLOCK_ROWS, KERNEL_BLOCK_COLS, KERNEL_BLOCK_D = 128, 128, 32

_c = ctypes
GMM = Kernel("gmm", source="gmm", symbol="gmm_launch",
             argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 7 + [_c.c_void_p])
GMM_DX = Kernel("gmm_dx", source="gmm", symbol="gmm_dx_launch",
                argtypes=[_c.c_void_p] * 3 + [_c.c_int] * 5 + [_c.c_void_p])
GMM_DW = Kernel("gmm_dw", source="gmm", symbol="gmm_dw_launch",
                argtypes=[_c.c_void_p] * 3 + [_c.c_int] * 5 + [_c.c_void_p])
#: bf16 and fp16 off gmm.cu's blocks (``csrc/gmm_any.cu``): wgmma, the
#: stages filled by TMA (route ``"wgmma_any"``) or by the producer
#: warpgroup's copies (``"wgmma_ld"``), chosen by the last argument
GMM_ANY = Kernel("gmm_any", source="gmm_any", symbol="gmm_any_launch",
                 argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 9 + [_c.c_void_p])
GMM_DX_ANY = Kernel("gmm_dx_any", source="gmm_any", symbol="gmm_any_dx_launch",
                    argtypes=[_c.c_void_p] * 3 + [_c.c_int] * 7
                    + [_c.c_void_p])
GMM_DW_ANY = Kernel("gmm_dw_any", source="gmm_any", symbol="gmm_any_dw_launch",
                    argtypes=[_c.c_void_p] * 3 + [_c.c_int] * 7
                    + [_c.c_void_p])
#: fp32 (``csrc/gmm_simt.cu``): any shape, plain fp32 FMA on the CUDA cores
GMM_SIMT = Kernel("gmm_simt", source="gmm_simt", symbol="gmm_simt_launch",
                  argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 8 + [_c.c_void_p])
GMM_DX_SIMT = Kernel("gmm_dx_simt", source="gmm_simt",
                     symbol="gmm_simt_dx_launch",
                     argtypes=[_c.c_void_p] * 3 + [_c.c_int] * 6
                     + [_c.c_void_p])
GMM_DW_SIMT = Kernel("gmm_dw_simt", source="gmm_simt",
                     symbol="gmm_simt_dw_launch",
                     argtypes=[_c.c_void_p] * 3 + [_c.c_int] * 6
                     + [_c.c_void_p])

#: what TMA can describe: 2-byte rows of a multiple of 8 elements (16-byte
#: row strides)
TMA_ROW_ELEMS = 8


def _route(name: str, dtypes, blocks: bool, tma: bool) -> str:
    """``"wgmma"`` for bfloat16 that fits gmm.cu's blocks (``blocks``,
    alignment included), else for bfloat16 and float16 ``"wgmma_any"``
    where TMA can describe the rows (``tma``) and ``"wgmma_ld"`` where it
    cannot; ``"simt"`` for float32.  Raises TypeError for a dtype no kernel
    takes."""
    dtypes = set(dtypes)
    if len(dtypes) != 1 or not dtypes <= set(SIMT_DTYPES):
        raise TypeError(f"{name} takes float32, bfloat16 or float16 operands "
                        f"of one dtype, got {sorted(map(str, dtypes))}")
    if dtypes == {torch.float32}:
        return "simt"
    if dtypes == {torch.bfloat16} and blocks:
        return "wgmma"
    return "wgmma_any" if tma else "wgmma_ld"


def _tma_rows(aligned: bool, *widths: int) -> bool:
    return aligned and all(w > 0 and w % TMA_ROW_ELEMS == 0 for w in widths)


def gmm_route(x_dtype, w_dtype, bm: int, d: int, f: int,
              aligned: bool = True) -> str:
    """The kernel ``gmm_cuda`` launches for x tiles (T, bm, d) and weights
    (E, d, f) of these dtypes: ``"wgmma"`` (``gmm``) for bfloat16 with bm
    and f multiples of 128 and d of 32, ``"wgmma_any"`` (``gmm_any``, TMA)
    for every other bfloat16 or float16 call with d and f multiples of 8,
    ``"wgmma_ld"`` (``gmm_any``, the thread loader) for the other 2-byte
    calls, ``"simt"`` (``gmm_simt``) for float32.  ``aligned``: both
    operands' data 16-byte aligned."""
    tma = bm > 0 and _tma_rows(aligned, d, f)
    return _route("gmm", (x_dtype, w_dtype), tma
                  and bm % KERNEL_BLOCK_ROWS == 0
                  and f % KERNEL_BLOCK_COLS == 0 and d % KERNEL_BLOCK_D == 0,
                  tma)


def gmm_dx_route(dy_dtype, w_dtype, r: int, d: int, f: int,
                 aligned: bool = True) -> str:
    """As :func:`gmm_route` for dX = dY W^T (``gmm_dx`` needs R and d
    multiples of 128, f of 32; TMA R > 0, d and f multiples of 8)."""
    tma = r > 0 and _tma_rows(aligned, d, f)
    return _route("gmm_dx", (dy_dtype, w_dtype), tma
                  and r % KERNEL_BLOCK_ROWS == 0
                  and d % KERNEL_BLOCK_COLS == 0 and f % KERNEL_BLOCK_D == 0,
                  tma)


def gmm_dw_route(x_dtype, dy_dtype, r: int, d: int, f: int,
                 aligned: bool = True) -> str:
    """As :func:`gmm_route` for dW = X^T dY (``gmm_dw`` needs d and f
    multiples of 128, R > 0; TMA R > 0, d and f multiples of 8)."""
    tma = r > 0 and _tma_rows(aligned, d, f)
    return _route("gmm_dw", (x_dtype, dy_dtype), tma
                  and d % KERNEL_BLOCK_ROWS == 0
                  and f % KERNEL_BLOCK_COLS == 0, tma)


#: the kernel of each product by route
GMM_BY_ROUTE = {"wgmma": GMM, "wgmma_any": GMM_ANY, "wgmma_ld": GMM_ANY,
                "simt": GMM_SIMT}
GMM_DX_BY_ROUTE = {"wgmma": GMM_DX, "wgmma_any": GMM_DX_ANY,
                   "wgmma_ld": GMM_DX_ANY, "simt": GMM_DX_SIMT}
GMM_DW_BY_ROUTE = {"wgmma": GMM_DW, "wgmma_any": GMM_DW_ANY,
                   "wgmma_ld": GMM_DW_ANY, "simt": GMM_DW_SIMT}


def _launch(kernels: dict, route: str, args, dtype, stream) -> None:
    """Launch the route's kernel: gmm.cu's takes no dtype, gmm_any.cu's the
    dtype and the loader, gmm_simt.cu's the dtype."""
    if route == "wgmma":
        kernels[route].launch(*args, stream)
    elif route == "simt":
        kernels[route].launch(*args, SIMT_DTYPES[dtype], stream)
    else:
        kernels[route].launch(*args, SIMT_DTYPES[dtype],
                              int(route == "wgmma_ld"), stream)


def _aligned(*tensors) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in tensors)


def span_bounds(n: int, p: int) -> np.ndarray:
    """(p + 1,) offsets splitting ``n`` steps into ``p`` contiguous spans
    (the identity order's split)."""
    return np.asarray([(w * n) // p for w in range(p + 1)], np.int32)


def grouped_matmul_tiles_plain(x_tiles, weights, tile_expert):
    """The plain PyTorch version: x_tiles (T, bm, d), weights (E, d, f),
    tile_expert (T,) -> (T, bm, f), fp32 products cast to the input type,
    on any device (the oracle of ``ref.py``)."""
    return grouped_matmul_ref(x_tiles, weights, tile_expert)


def gmm_cuda(x_tiles, weights, tile_expert, order, bounds, n_span: int):
    """Launch ``gmm``, ``gmm_any`` or ``gmm_simt`` (:func:`gmm_route`): step i of
    ``order`` multiplies x tile ``order[i]`` by
    expert ``tile_expert[order[i]]`` into output tile ``order[i]``.

    ``bounds`` (p + 1,) gives each CTA's live steps ``[b[w], b[w+1])`` of
    the first ``n_span`` steps; steps from ``n_span`` on are dealt
    round-robin.  Returns a new (T, bm, f) tensor of x's dtype.
    """
    t, bm, k = x_tiles.shape
    e, d, f = weights.shape
    if d != k or tuple(tile_expert.shape) != (t,):
        raise ValueError(f"x_tiles {tuple(x_tiles.shape)}, weights "
                         f"{tuple(weights.shape)} and tile_expert "
                         f"{tuple(tile_expert.shape)} do not agree")
    _check_contiguous(x_tiles=x_tiles, weights=weights)
    route = gmm_route(x_tiles.dtype, weights.dtype, bm, d, f,
                      _aligned(x_tiles, weights))
    order = np.asarray(order, np.int32).reshape(-1)
    if not np.array_equal(np.sort(order), np.arange(t)) or not 0 <= n_span <= t:
        raise ValueError("order must be a permutation of the T tiles and "
                         "n_span lie in [0, T]")
    host = np.concatenate([order, np.asarray(bounds, np.int32)])
    out = torch.empty((t, bm, f), dtype=x_tiles.dtype, device=x_tiles.device)
    # freed when this returns: the caching allocator reuses it only for work
    # queued after the kernel on the same stream.  Copied from pinned memory
    # without blocking, so the host does not wait for the stream to drain.
    table = torch.from_numpy(host).pin_memory().to(x_tiles.device,
                                                   non_blocking=True)
    te = tile_expert.to(device=x_tiles.device, dtype=torch.int32).contiguous()
    ptr = table.data_ptr()
    args = (x_tiles.data_ptr(), weights.data_ptr(), out.data_ptr(), ptr,
            te.data_ptr(), ptr + 4 * t, len(bounds) - 1, n_span, t, bm, d, f,
            e)
    _launch(GMM_BY_ROUTE, route, args, x_tiles.dtype,
            torch.cuda.current_stream(x_tiles.device).cuda_stream)
    return out


def _check_contiguous(**tensors) -> None:
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gmm_dx_cuda(dy, weights, *, sched_p: int):
    """Launch ``gmm_dx`` (or ``gmm_dx_any`` / ``gmm_dx_simt``,
    :func:`gmm_dx_route`): dX[e] =
    dy[e] weights[e]^T for dy (E, R, f) and weights (E, d, f), read in
    place, fp32 sums over f, on ``sched_p`` persistent CTAs over the
    expert-major units.  Returns a new (E, R, d) tensor of dy's dtype."""
    if dy.dim() != 3 or weights.dim() != 3:
        raise ValueError(f"dy {tuple(dy.shape)} and weights "
                         f"{tuple(weights.shape)} must be 3-D")
    e, r, f = dy.shape
    if weights.shape[0] != e or weights.shape[2] != f:
        raise ValueError(f"dy {tuple(dy.shape)} and weights "
                         f"{tuple(weights.shape)} do not agree")
    d = weights.shape[1]
    _check_contiguous(dy=dy, weights=weights)
    route = gmm_dx_route(dy.dtype, weights.dtype, r, d, f,
                         _aligned(dy, weights))
    dx = torch.empty((e, r, d), dtype=dy.dtype, device=dy.device)
    args = (dy.data_ptr(), weights.data_ptr(), dx.data_ptr(), e, r, d, f,
            sched_p)
    _launch(GMM_DX_BY_ROUTE, route, args, dy.dtype,
            torch.cuda.current_stream(dy.device).cuda_stream)
    return dx


def gmm_dw_cuda(xe, dy, *, sched_p: int):
    """Launch ``gmm_dw`` (or ``gmm_dw_any`` / ``gmm_dw_simt``,
    :func:`gmm_dw_route`): dW[e] =
    xe[e]^T dy[e] for xe (E, R, d) and dy (E, R, f), fp32 sums over the R
    rows in ascending order, on ``sched_p`` persistent CTAs.  Returns a new
    (E, d, f) tensor of xe's dtype."""
    e, r, d = xe.shape
    if dy.dim() != 3 or dy.shape[:2] != xe.shape[:2]:
        raise ValueError(f"xe {tuple(xe.shape)} and dy {tuple(dy.shape)} do "
                         "not agree")
    f = dy.shape[2]
    _check_contiguous(xe=xe, dy=dy)
    route = gmm_dw_route(xe.dtype, dy.dtype, r, d, f, _aligned(xe, dy))
    dw = torch.empty((e, d, f), dtype=xe.dtype, device=xe.device)
    args = (xe.data_ptr(), dy.data_ptr(), dw.data_ptr(), e, r, d, f, sched_p)
    _launch(GMM_DW_BY_ROUTE, route, args, xe.dtype,
            torch.cuda.current_stream(xe.device).cuda_stream)
    return dw


def grouped_matmul_bwd_plain(xe, weights, dy, *, need_dx: bool = True,
                             need_dw: bool = True):
    """The plain version of the backward of xe (E, R, d) @ weights (E, d, f)
    for the output gradient dy (E, R, f): (dx, dw), fp32 products cast to
    the types of xe and weights, None where not asked for; any device."""
    dx = dw = None
    if need_dx:
        dx = torch.einsum("erf,edf->erd", dy.float(),
                          weights.float()).to(xe.dtype)
    if need_dw:
        dw = torch.einsum("erd,erf->edf", xe.float(),
                          dy.float()).to(weights.dtype)
    return dx, dw


def grouped_matmul_bwd(xe, weights, dy, *, need_dx: bool = True,
                       need_dw: bool = True, sched_p: int = 8):
    """(dx, dw) of xe (E, R, d) @ weights (E, d, f) for dy (E, R, f), None
    where not asked for, in the operands' one dtype.  On the
    card dx is ``gmm_dx`` and dw ``gmm_dw`` (or, off their blocks and
    dtype, ``gmm_dx_any`` / ``gmm_dw_any`` or the fp32 kernels), each on ``sched_p`` persistent CTAs; on the CPU the plain version."""
    dev = check_device(xe, weights, dy)
    if dev.type == "cpu":
        return grouped_matmul_bwd_plain(xe, weights, dy, need_dx=need_dx,
                                        need_dw=need_dw)
    dy = dy.contiguous()
    dx = gmm_dx_cuda(dy, weights, sched_p=sched_p) if need_dx else None
    dw = gmm_dw_cuda(xe.contiguous(), dy, sched_p=sched_p) if need_dw else None
    return dx, dw


def grouped_matmul_tiles(x_tiles, weights, tile_expert, *, sched_p: int = 8):
    """x_tiles: (T, bm, d) row tiles; weights: (E, d, f);
    tile_expert: (T,) int32 expert id per tile -> out (T, bm, f).

    The tile order is the caller's.  On the card the T tiles are split
    into ``sched_p`` contiguous spans, one per CTA.
    """
    dev = check_device(x_tiles, weights)
    if dev.type == "cpu":
        return grouped_matmul_tiles_plain(x_tiles, weights, tile_expert)
    t = x_tiles.shape[0]
    te = torch.as_tensor(tile_expert, device=dev)
    if te.numel() and not 0 <= int(te.min()) <= int(te.max()) < weights.shape[0]:
        raise ValueError(f"tile_expert must lie in [0, {weights.shape[0]})")
    return gmm_cuda(x_tiles, weights, te, np.arange(t, dtype=np.int32),
                    span_bounds(t, sched_p), t)

