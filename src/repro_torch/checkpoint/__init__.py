"""Atomic, async, validated checkpointing of flat mappings of tensors."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
