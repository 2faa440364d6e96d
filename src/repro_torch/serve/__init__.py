"""Serving, ported from ``src/repro/serve``: DLS continuous batching and the
decode engine.  Cluster routing, elasticity and resilience wait for a
later slice (ROADMAP.md)."""

from .engine import DecodeEngine, EngineStats  # noqa: F401
from .scheduler import Request, RequestScheduler, simulate_serving  # noqa: F401
