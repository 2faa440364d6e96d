"""The backward of the ragged MoE's expert product on the CPU: the plain
dX / dW (``grouped_matmul_bwd_plain``, the versions ``gmm_dx`` and
``gmm_dw`` are held to on the card) and
``models.moe._ExpertMatmul`` against ``jax.vjp`` of the reference's grouped
product (``repro.kernels.grouped_matmul.ref.grouped_matmul_ref``).

Inputs come from numpy seeds.  Tolerance (fp32; the two frameworks sum in
another order, nothing else): |port - reference| <= RTOL |reference| +
ATOL elementwise, RTOL = ATOL = 1e-5 (the sums run over at most 64 terms
of magnitude ~1).
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as jax_gmm_ref
from repro_torch.kernels import _build
from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
from repro_torch.models import moe as tmoe

RTOL = ATOL = 1e-5
BM = 8
# (experts, rows per expert, d, f)
SHAPES = ((3, 16, 24, 40), (2, 8, 64, 16), (1, 24, 8, 8))


def _inputs(seed, e, r, d, f):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(e, r, d)).astype(np.float32),
            rng.normal(size=(e, d, f)).astype(np.float32) * d ** -0.5,
            rng.normal(size=(e, r, f)).astype(np.float32))


def _reference_grads(x, w, dy):
    """dX (E, R, d) and dW (E, d, f) by jax.vjp of the reference's grouped
    product over the (E * R / BM) row tiles of BM rows."""
    e, r, d = x.shape
    tiles = r // BM
    te = jnp.arange(e * tiles) // tiles
    _, vjp = jax.vjp(lambda xt, w_: jax_gmm_ref(xt, w_, te),
                     jnp.asarray(x.reshape(e * tiles, BM, d)), jnp.asarray(w))
    dxt, dw = vjp(jnp.asarray(dy.reshape(e * tiles, BM, -1)))
    return np.asarray(dxt).reshape(e, r, d), np.asarray(dw)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_reference_vjp(shape):
    """``grouped_matmul_bwd_plain`` and the CPU route of
    ``grouped_matmul_bwd`` against ``jax.vjp`` of the reference product."""
    x, w, dy = _inputs(sum(shape), *shape)
    want_dx, want_dw = _reference_grads(x, w, dy)
    tx, tw, tdy = map(torch.from_numpy, (x, w, dy))
    for fn in (gm.grouped_matmul_bwd_plain, gm.grouped_matmul_bwd):
        dx, dw = fn(tx, tw, tdy)
        _close(dx, want_dx)
        _close(dw, want_dw)


def test_expert_matmul_function_matches_reference_vjp():
    """``_expert_matmul`` under autograd on CPU tensors: its output against
    the reference product and its gradients against ``jax.vjp``, with no
    kernel launched."""
    e, r, d, f = 3, 128, 16, 24       # R a multiple of the 128-row tile
    x, w, dy = _inputs(7, e, r, d, f)
    want_dx, want_dw = _reference_grads(x, w, dy)
    tiles = r // BM
    want_y = np.asarray(jax_gmm_ref(
        jnp.asarray(x.reshape(e * tiles, BM, d)), jnp.asarray(w),
        jnp.arange(e * tiles) // tiles)).reshape(e, r, f)
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    _build.reset_launches()
    y = tmoe._expert_matmul(tx, tw)
    assert y.grad_fn is not None
    _close(y, want_y)
    y.backward(torch.from_numpy(dy))
    _close(tx.grad, want_dx)
    _close(tw.grad, want_dw)
    assert all(k.launches == 0 for k in _build.KERNELS.values())


def test_expert_matmul_computes_only_requested_grads(monkeypatch):
    """No dW when the weights do not require grad, no dX when the rows do
    not: the backward asks ``grouped_matmul_bwd`` for just those."""
    seen = []
    real = tmoe.grouped_matmul_bwd

    def spy(*args, **kwargs):
        seen.append((kwargs["need_dx"], kwargs["need_dw"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(tmoe, "grouped_matmul_bwd", spy)
    x, w, dy = (torch.from_numpy(a) for a in _inputs(3, 2, 128, 8, 16))
    for rows_grad, w_grad in ((True, False), (False, True), (True, True)):
        tx = x.clone().requires_grad_(rows_grad)
        tw = w.clone().requires_grad_(w_grad)
        tmoe._expert_matmul(tx, tw).backward(dy)
        assert seen.pop() == (rows_grad, w_grad)
        assert (tx.grad is not None) == rows_grad
        assert (tw.grad is not None) == w_grad
    dx, dw = gm.grouped_matmul_bwd_plain(x, w, dy, need_dx=False)
    assert dx is None and dw.shape == w.shape
    dx, dw = gm.grouped_matmul_bwd_plain(x, w, dy, need_dw=False)
    assert dw is None and dx.shape == x.shape


def test_plain_backward_keeps_the_input_types():
    """bf16 rows and weights give bf16 gradients (fp32 sums, one rounding),
    within one bf16 step of the fp32 gradients."""
    x, w, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 16, 32, 16))
    dx, dw = gm.grouped_matmul_bwd_plain(x.bfloat16(), w.bfloat16(),
                                         dy.bfloat16())
    assert dx.dtype == dw.dtype == torch.bfloat16
    fx, fw = gm.grouped_matmul_bwd_plain(x.bfloat16().float(),
                                         w.bfloat16().float(),
                                         dy.bfloat16().float())
    for got, want in ((dx, fx), (dw, fw)):
        assert float((got.float() - want).abs().max()) <= \
            2.0 ** -8 * float(want.abs().max())
