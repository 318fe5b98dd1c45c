"""Atomic, retention-managed checkpointing (the reference's layout)."""

from .manager import CheckpointManager  # noqa: F401
