"""DLS applied to framework decisions (port of ``src/repro/balance``;
``accum.py`` waits for a later slice)."""

from .moe import MoEBalancer, plan_tiles  # noqa: F401
