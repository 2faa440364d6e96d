"""DLS applied to framework decisions (port of ``src/repro/balance``)."""

from .accum import AccumPlanner  # noqa: F401
from .moe import MoEBalancer, plan_tiles  # noqa: F401
