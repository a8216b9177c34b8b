# Atomic, checksummed checkpoints of parameter / optimizer trees in the
# reference's on-disk layout, with an async writer and retention.
from .manager import (CheckpointManager, latest_step, restore_checkpoint,
                      save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step"]
