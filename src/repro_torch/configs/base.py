"""Config system: model / parallelism / run configuration dataclasses.

A copy of ``src/repro/configs/base.py`` for the PyTorch port (that module
imports JAX).  Every assigned architecture is a `ModelConfig` in its own
module (``repro_torch/configs/<id>.py``) registered in
``configs/__init__.py``; shapes are `ShapeConfig`s shared across archs.
`input_specs()` produces ``torch.empty(..., device="meta")`` stand-ins (no
allocation) where the reference makes ShapeDtypeStructs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
BlockKind = Literal["attn", "local_attn", "mlstm", "slstm", "rglru"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01  # load-balance auxiliary loss weight
    # 'dense' = all-experts compute, gate-combined (roofline baseline);
    # 'ragged' = sort-based dispatch feeding DLS-planned expert tiles
    dispatch: Literal["dense", "ragged"] = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                       # dense FFN hidden (0 => no dense FFN)
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    # block pattern: repeated to cover num_layers; default all-attention
    block_pattern: tuple[BlockKind, ...] = ("attn",)
    window: int = 0                 # sliding window for local_attn blocks
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    activation: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm_eps: float = 1e-6
    # recurrent dims
    lru_width: int = 0              # RG-LRU width (0 => d_model)
    conv_width: int = 4             # temporal conv in recurrent blocks
    # modality stub: number of precomputed prefix embeddings (VLM patches /
    # audio conditioning frames) supplied by input_specs()
    prefix_len: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # remat policy for the layer scan: 'none' | 'dots' | 'full'
    remat: str = "full"
    logit_softcap: float = 0.0
    # per-arch logical->mesh rule overrides (e.g. sequence-parallel
    # fallback when the head count doesn't divide the model axis)
    sharding_overrides: tuple[tuple[str, object], ...] = ()
    # attention switches to the flash KV-block-scan path above this seq len
    flash_threshold: int = 2048
    # unroll the layer scan (True for dry-run cost accounting: XLA's
    # cost_analysis counts a while-loop body once, so an unrolled lowering
    # is what makes HLO_FLOPs trustworthy)
    scan_unroll: bool = False
    # cross-entropy computed in seq chunks of this size (bounds the
    # (b, s, vocab) logits transient); 0 = unchunked
    loss_chunk: int = 512
    # gradient-accumulation microbatches for the production train step
    train_microbatches: int = 4
    # token groups for group-local ragged MoE dispatch (== data shards)
    moe_groups: int = 32
    # decode KV cache dtype: 'bfloat16' or 'int8' (quantized, §Perf)
    kv_cache_dtype: str = "bfloat16"
    # gather weights at use time (bf16, d-dim unsharded) instead of letting
    # GSPMD all-reduce partial matmul outputs over the data axis (§Perf B1)
    gather_weights: bool = False

    # -- derived -------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab dim shards
        cleanly on the model axis (standard embedding padding)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def pattern_layers(self) -> tuple[BlockKind, ...]:
        """Full per-layer block kinds (pattern tiled over num_layers)."""
        reps = math.ceil(self.num_layers / len(self.block_pattern))
        return tuple((self.block_pattern * reps)[: self.num_layers])

    @property
    def supports_long_context(self) -> bool:
        """True if decode state is O(1)/O(window) — i.e. no full-attention
        KV cache (pattern contains no global 'attn' block)."""
        return "attn" not in self.pattern_layers

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for kind in self.pattern_layers:
            if kind in ("attn", "local_attn"):
                total += d * self.num_heads * hd  # q
                total += 2 * d * self.num_kv_heads * hd  # k,v
                total += self.num_heads * hd * d  # o
                if self.qk_norm:
                    total += 2 * hd
                total += d  # pre-norm
            elif kind == "mlstm":
                total += 3 * d * d + d * d + 2 * d  # qkv + out + gates-ish
                total += d
            elif kind == "slstm":
                hd_s = d // max(self.num_heads, 1)
                total += 4 * d * d + 4 * self.num_heads * hd_s * hd_s + d
            elif kind == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + w * d  # in (x & gate branches) + out
                total += w * self.conv_width  # conv
                total += 3 * w  # lambda + input/rec gates (diagonal-ish)
                total += d
            if self.moe is not None:
                e = self.moe
                total += d * e.num_experts  # router
                total += e.num_experts * self._ffn_params(d, e.d_ff)
                total += d
            elif self.d_ff > 0:
                total += self._ffn_params(d, self.d_ff)
                total += d
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts instead of all)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        dense_like = self.param_count()
        per_expert = self._ffn_params(self.d_model, e.d_ff)
        inactive = (e.num_experts - e.top_k) * per_expert * self.num_layers
        return dense_like - inactive

    def _ffn_params(self, d: int, ff: int) -> int:
        if self.activation in ("swiglu", "geglu"):
            return 3 * d * ff
        return 2 * d * ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason-if-not). long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not model.supports_long_context:
        return False, "skipped(full-attention): 500k decode needs sub-quadratic attention"
    return True, ""


# ---------------------------------------------------------------------------
# input_specs: meta-tensor stand-ins (dry-run pattern — no allocation)
# ---------------------------------------------------------------------------


def input_specs(model: ModelConfig, shape: ShapeConfig) -> dict:
    """Model inputs as meta tensors (shape and dtype, no storage).

    train:   tokens/labels (B, S)  [+ prefix embeddings for vlm/audio stubs]
    prefill: tokens (B, S)
    decode:  token (B, 1) + KV/recurrent cache specs are created separately
             by the serving layer.
    """
    b, s = shape.global_batch, shape.seq_len

    def spec(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    specs: dict = {}
    if shape.kind == "train":
        body = s - model.prefix_len
        specs["tokens"] = spec((b, body))
        specs["labels"] = spec((b, body))
    elif shape.kind == "prefill":
        body = s - model.prefix_len
        specs["tokens"] = spec((b, body))
    else:  # decode: one new token against a cache of length s
        specs["tokens"] = spec((b, 1))
    if model.prefix_len > 0 and shape.kind != "decode":
        # modality frontend stub: precomputed patch/frame embeddings
        specs["prefix_embed"] = spec((b, model.prefix_len, model.d_model),
                                     torch.bfloat16)
    return specs


def smoke_config(model: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small layers/width,
    few experts, tiny vocab; same block pattern and code paths."""
    moe = None
    if model.moe is not None:
        moe = dataclasses.replace(
            model.moe, num_experts=min(model.moe.num_experts, 4),
            top_k=min(model.moe.top_k, 2), d_ff=32,
        )
    pat_period = len(model.block_pattern)
    # cover the group-scan path: >= 1 full pattern group
    smoke_layers = 2 * pat_period if pat_period <= 3 else pat_period
    return dataclasses.replace(
        model,
        name=model.name + "-smoke",
        num_layers=max(2, smoke_layers),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(model.num_kv_heads, 2) if model.num_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128 if model.d_ff > 0 else 0,
        vocab_size=256,
        lru_width=64 if model.lru_width else 0,
        window=min(model.window, 32) if model.window else 0,
        prefix_len=min(model.prefix_len, 4),
        moe=moe,
        moe_groups=2,
        remat="none",
    )
