"""Gradient compression for a cross-pod reduction.  Port of
``src/repro/optim/compression.py``.

  * int8 block quantization with max-abs scales (8x over f32, 4x over bf16
    on the wire);
  * error-feedback accumulation (the quantization residual is carried into
    the next step, preserving convergence: Seide et al. / EF-SGD);
  * ``compressed_psum``: the reference's reduction inside ``shard_map``
    (quantize, integer psum, dequantize) as ``torch.distributed``
    all-reduces over a process group: the per-block scales by MAX, then
    the int32 payload by SUM;
  * ``wire_bytes_saved``: the wire bytes of one such reduction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_unflatten

__all__ = ["quantize_int8", "dequantize_int8", "EFState", "ef_init",
           "ef_compress_decompress", "compressed_psum", "wire_bytes_saved"]

BLOCK = 2048  # quantization block (per-block scales bound the error)


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), pad


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 blocks (n, BLOCK), f32 scales (n,)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    blocks, _ = _pad_to_block(x)
    amax = torch.amax(torch.abs(blocks), dim=1)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


class EFState(NamedTuple):
    residual: object  # tree like grads


def ef_init(grads) -> EFState:
    leaves = tree_leaves(grads)
    return EFState(residual=tree_unflatten(grads, [
        torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for g in leaves]))


def ef_compress_decompress(grads, ef: EFState) -> tuple[object, EFState]:
    """Error-feedback int8 round trip: returns (decompressed grads, new
    residual state).  What a receiver would see after the compressed
    reduction; the residual re-enters next step's gradients."""

    def one(g, r):
        g = g.to(torch.float32) + r
        q, s = quantize_int8(g)
        deq = dequantize_int8(q, s, g.shape)
        return deq, g - deq

    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(ef.residual))]
    deq = tree_unflatten(grads, [o[0] for o in out])
    res = tree_unflatten(grads, [o[1] for o in out])
    return deq, EFState(residual=res)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Quantize -> integer all-reduce -> dequantize over ``group`` (the
    default process group if None): every rank returns the sum.

    The int8 payload is summed in int32 (no overflow for group sizes
    < 2^23); scales are max-reduced so dequantization is conservative.
    Wire cost: 1 byte/elem + scales, vs 4 (f32) or 2 (bf16).
    """
    _, scale = quantize_int8(x)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    # requantize against the shared scale so the integer sum is exact
    blocks, _ = _pad_to_block(x)
    q_shared = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127
                           ).to(torch.int8)
    total = q_shared.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    flat = (total.to(torch.float32) * scale[:, None]).reshape(-1)
    return flat[:x.numel()].reshape(x.shape).to(x.dtype)


def wire_bytes_saved(grads, pod_count: int = 2) -> dict:
    """Accounting helper: f32/bf16/int8 wire bytes for one cross-pod
    gradient all-reduce."""
    n = sum(int(g.numel()) for g in tree_leaves(grads))
    blocks = -(-n // BLOCK)
    return dict(
        elements=n,
        f32_bytes=4 * n,
        bf16_bytes=2 * n,
        int8_bytes=n + 4 * blocks,
        ratio_vs_f32=round((n + 4 * blocks) / (4 * n), 4),
    )
