"""Chunked, integrity-checked, restartable checkpointing of torch state."""
from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    CorruptionError,
    SaveReport,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager", "CorruptionError", "SaveReport",
    "restore_checkpoint", "save_checkpoint",
]
