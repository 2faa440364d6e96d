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
see the note at the top of that file.
On a CPU tensor ``grouped_matmul_tiles_plain`` computes the same function.
Tiles are independent, so the output is bit-identical for every order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import check_device
from .._build import Kernel
from .ref import grouped_matmul_ref

#: what the CUDA kernel takes: block_rows and f multiples of its 128-row,
#: 128-column output blocks (256 columns where f allows), d a multiple of 32
#: (its 64-deep stages are zero-filled past d)
KERNEL_BLOCK_ROWS, KERNEL_BLOCK_COLS, KERNEL_BLOCK_D = 128, 128, 32

_c = ctypes
GMM = Kernel("gmm", source="gmm", symbol="gmm_launch",
             argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 7 + [_c.c_void_p])


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
    """Launch ``gmm``: step i of ``order`` multiplies x tile ``order[i]`` by
    expert ``tile_expert[order[i]]`` into output tile ``order[i]``.

    ``bounds`` (p + 1,) gives each CTA's live steps ``[b[w], b[w+1])`` of
    the first ``n_span`` steps; steps from ``n_span`` on are dealt
    round-robin.  Returns a new (T, bm, f) tensor.
    """
    t, bm, d = x_tiles.shape
    e, d2, f = weights.shape
    if d2 != d or tuple(tile_expert.shape) != (t,):
        raise ValueError(f"x_tiles {tuple(x_tiles.shape)}, weights "
                         f"{tuple(weights.shape)} and tile_expert "
                         f"{tuple(tile_expert.shape)} do not agree")
    if x_tiles.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError(f"gmm takes bfloat16 x and weights, got "
                        f"{x_tiles.dtype}, {weights.dtype}")
    if bm % KERNEL_BLOCK_ROWS or f % KERNEL_BLOCK_COLS or d % KERNEL_BLOCK_D:
        raise ValueError(
            f"gmm needs block_rows % {KERNEL_BLOCK_ROWS} == 0, f % "
            f"{KERNEL_BLOCK_COLS} == 0 and d % {KERNEL_BLOCK_D} == 0; got "
            f"bm={bm}, d={d}, f={f}")
    for name, x in (("x_tiles", x_tiles), ("weights", weights)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
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
    GMM.launch(x_tiles.data_ptr(), weights.data_ptr(), out.data_ptr(),
               ptr, te.data_ptr(), ptr + 4 * t, len(bounds) - 1, n_span, t,
               bm, d, f, e,
               torch.cuda.current_stream(x_tiles.device).cuda_stream)
    return out


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

