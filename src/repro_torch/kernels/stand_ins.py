"""Shape-only stand-ins of the kernels, for meta tensors.

The dry run (``launch/dryrun.py``) runs the model on DTensors whose local
shards lie on the meta device.  Where the card launches a kernel on a
local shard, a meta shard goes through one of these ``torch.library``
custom ops instead: the output's shape and dtype, no values, the same
local shapes as the kernel's, and a FLOP formula for
``torch.utils.flop_counter`` that counts the kernel's products as it runs
them:

  * ``flash_meta(q, k, v, window)``: ``flash_dense`` (causal, optional
    window), 2 products of 2 * hd FLOPs per unmasked (query, key) pair
    and head; its backward ``flash_meta_bwd`` counts ``flash_dense_bwd``'s
    7 (S and dP are computed in both the dK / dV and the dQ pass);
  * ``expert_matmul_meta(xe, w)``: ``gmm`` (E, R, K) @ (E, K, N), 2 E R K N;
    its backward is two more of the same (``gmm_dx`` and ``gmm_dw``);
  * ``slstm_scan_meta(r, zx)``: the sLSTM's time loop (no kernel: a
    Python loop of small ops, some 10^5 of them a layer at 4096
    positions, each a Python meta function on meta tensors), the
    recurrent product's 2 b 4 h hd^2 FLOPs a step, twice that backward;
    it saves its inputs and output only, not the loop's per-step tensors.

They are never called on tensors that hold values.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["flash_meta", "expert_matmul_meta", "slstm_scan_meta",
           "causal_pairs"]


def causal_pairs(s: int, window: int = 0) -> int:
    """Unmasked (query, key) pairs of a causal s x s mask, with a sliding
    ``window`` (0: none)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _stand_in(*_args):
    raise RuntimeError("a shape-only stand-in: it runs on meta tensors only")


@torch.library.custom_op("repro_torch::flash_meta", mutates_args=())
def flash_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int) -> torch.Tensor:
    """q (b, s, h, hd), k / v (b, s, kvh, hd) -> (b, s, h, hd)."""
    _stand_in()


@flash_meta.register_fake
def _(q, k, v, window):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_meta_bwd", mutates_args=())
def flash_meta_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, window: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _stand_in()


@flash_meta_bwd.register_fake
def _(q, k, v, do, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.window = window


def _flash_backward(ctx, do):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = flash_meta_bwd(q, k, v, do, ctx.window)
    return dq, dk, dv, None


flash_meta.register_autograd(_flash_backward, setup_context=_flash_setup)


def _flash_flops(q_shape, window: int, products: int) -> int:
    b, s, h, hd = q_shape
    return products * 2 * b * h * hd * causal_pairs(s, window)


@register_flop_formula(torch.ops.repro_torch.flash_meta)
def _(q_shape, k_shape, v_shape, window, *args, out_shape=None, **kwargs):
    return _flash_flops(q_shape, window, 2)


@register_flop_formula(torch.ops.repro_torch.flash_meta_bwd)
def _(q_shape, k_shape, v_shape, do_shape, window, *args, out_shape=None,
      **kwargs):
    return _flash_flops(q_shape, window, 7)


@torch.library.custom_op("repro_torch::expert_matmul_meta", mutates_args=())
def expert_matmul_meta(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xe (E, R, K) @ w (E, K, N) -> (E, R, N)."""
    _stand_in()


@expert_matmul_meta.register_fake
def _(xe, w):
    return xe.new_empty((xe.shape[0], xe.shape[1], w.shape[2]))


def _gmm_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _gmm_backward(ctx, dy):
    xe, w = ctx.saved_tensors
    return (expert_matmul_meta(dy, w.transpose(1, 2)),
            expert_matmul_meta(xe.transpose(1, 2), dy))


expert_matmul_meta.register_autograd(_gmm_backward, setup_context=_gmm_setup)


@register_flop_formula(torch.ops.repro_torch.expert_matmul_meta)
def _(xe_shape, w_shape, *args, out_shape=None, **kwargs):
    e, r, k = xe_shape
    return 2 * e * r * k * w_shape[2]


@torch.library.custom_op("repro_torch::slstm_scan_meta", mutates_args=())
def slstm_scan_meta(r: torch.Tensor, zx: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """r (4, h, hd, hd), zx (b, s, 4, d) -> (y (b, s, d) fp32, and the final
    c, n, h, m (b, d) fp32)."""
    _stand_in()


@slstm_scan_meta.register_fake
def _(r, zx):
    b, s, _, d = zx.shape
    state = zx.new_empty((b, d), dtype=torch.float32)
    return (zx.new_empty((b, s, d), dtype=torch.float32), state,
            torch.empty_like(state), torch.empty_like(state),
            torch.empty_like(state))


@torch.library.custom_op("repro_torch::slstm_scan_meta_bwd", mutates_args=())
def slstm_scan_meta_bwd(r: torch.Tensor, zx: torch.Tensor, dy: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    _stand_in()


@slstm_scan_meta_bwd.register_fake
def _(r, zx, dy):
    return torch.empty_like(r), torch.empty_like(zx)


def _slstm_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _slstm_backward(ctx, dy, *_state_grads):
    r, zx = ctx.saved_tensors
    return slstm_scan_meta_bwd(r, zx, dy)


slstm_scan_meta.register_autograd(_slstm_backward,
                                  setup_context=_slstm_setup)


def _slstm_flops(r_shape, zx_shape) -> int:
    _, h, hd, _ = r_shape
    b, s = zx_shape[:2]
    return s * 2 * b * 4 * h * hd * hd


@register_flop_formula(torch.ops.repro_torch.slstm_scan_meta)
def _(r_shape, zx_shape, *args, out_shape=None, **kwargs):
    return _slstm_flops(r_shape, zx_shape)


@register_flop_formula(torch.ops.repro_torch.slstm_scan_meta_bwd)
def _(r_shape, zx_shape, dy_shape, *args, out_shape=None, **kwargs):
    return 2 * _slstm_flops(r_shape, zx_shape)
