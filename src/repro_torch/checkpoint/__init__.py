"""Checkpointing in the reference's on-disk format (port of
``src/repro/checkpoint``)."""

from .store import CheckpointStore  # noqa: F401
