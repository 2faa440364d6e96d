"""Optimization and gradient compression (port of ``src/repro/optim``)."""

from .adamw import (  # noqa: F401
    AdamWState,
    OptimizerConfig,
    adamw_init,
    adamw_state_axes,
    adamw_update,
    lr_schedule,
)
from . import compression  # noqa: F401
