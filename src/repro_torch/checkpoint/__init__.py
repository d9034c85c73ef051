"""Checkpointing: atomic async save, keep-k GC, restore into a template."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
