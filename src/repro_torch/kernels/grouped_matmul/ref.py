"""Plain PyTorch oracle for the grouped expert-tile matmul."""

from __future__ import annotations

import torch


def grouped_matmul_ref(x_tiles, weights, tile_expert):
    """x_tiles (T, bm, d), weights (E, d, f), tile_expert (T,) ->
    (T, bm, f): each tile multiplied by its expert's weight."""
    w_sel = weights[torch.as_tensor(tile_expert, device=weights.device).long()]
    return torch.einsum("tbd,tdf->tbf", x_tiles.float(),
                        w_sel.float()).to(x_tiles.dtype)
