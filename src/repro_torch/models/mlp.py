"""Dense FFN: SwiGLU / GeGLU / plain-GELU variants.  Port of
``src/repro/models/mlp.py``."""

from __future__ import annotations

import torch

from ..sharding import Ax, shard_as
from .layers import activate, dense_init, use_weight


def init_mlp(gen: torch.Generator, cfg):
    d, ff = cfg.d_model, cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    params = {"wi": dense_init(gen, d, ff, "embed", "mlp")[0]}
    axes = {"wi": Ax("embed", "mlp"), "wo": Ax("mlp", "embed")}
    if gated:
        params["wg"] = dense_init(gen, d, ff, "embed", "mlp")[0]
        axes["wg"] = Ax("embed", "mlp")
    params["wo"] = dense_init(gen, ff, d, "mlp", "embed")[0]
    return params, axes


def mlp(params, cfg, x):
    dt = x.dtype
    wi = use_weight(params["wi"].to(dt), cfg, None, "mlp")
    h_lin = x @ wi
    if "wg" in params:
        wg = use_weight(params["wg"].to(dt), cfg, None, "mlp")
        h = activate(x @ wg, h_lin, cfg.activation)
    else:
        h = activate(h_lin, None, cfg.activation)
    h = shard_as(h, "batch", "seq", "mlp")
    wo = use_weight(params["wo"].to(dt), cfg, "mlp", None)
    out = h @ wo
    return shard_as(out, "batch", "seq", "embed_act")
