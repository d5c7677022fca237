"""Atomic, async, validated checkpointing of flat mappings of tensors."""
from repro_torch.checkpoint.manager import (CheckpointManager, flat_logical,
                                           reshard_tree)

__all__ = ["CheckpointManager", "flat_logical", "reshard_tree"]
