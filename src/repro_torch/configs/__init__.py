"""Architecture registry: --arch <id> resolves here."""

from .base import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    SHAPES,
    ShapeConfig,
    input_specs,
    shape_applicable,
    smoke_config,
)

from .granite_moe_1b_a400m import CONFIG as _granite_moe
from .qwen3_moe_30b_a3b import CONFIG as _qwen3_moe
from .xlstm_1_3b import CONFIG as _xlstm
from .stablelm_3b import CONFIG as _stablelm
from .codeqwen1_5_7b import CONFIG as _codeqwen
from .granite_20b import CONFIG as _granite20b
from .qwen3_4b import CONFIG as _qwen3_4b
from .internvl2_1b import CONFIG as _internvl2
from .musicgen_medium import CONFIG as _musicgen
from .recurrentgemma_2b import CONFIG as _rgemma

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _granite_moe, _qwen3_moe, _xlstm, _stablelm, _codeqwen,
        _granite20b, _qwen3_4b, _internvl2, _musicgen, _rgemma,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]

from .paper_campaign import CAMPAIGN, CampaignConfig  # noqa: F401
