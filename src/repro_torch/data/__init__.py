"""Synthetic corpus + DLS-packed batching (port of ``src/repro/data``)."""

from .pipeline import DataConfig, DataLoader, SyntheticCorpus, pack_documents  # noqa: F401
