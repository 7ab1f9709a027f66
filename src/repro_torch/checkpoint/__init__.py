"""The checkpoint store, PyTorch port of ``repro.checkpoint`` in the
reference's on-disk format (see :mod:`.manager`)."""
from .manager import (CheckpointManager, CheckpointCorruptError,
                      save_checkpoint, restore_checkpoint,
                      verify_checkpoint, latest_step, latest_valid_step,
                      list_steps)

__all__ = ["CheckpointManager", "CheckpointCorruptError", "save_checkpoint",
           "restore_checkpoint", "verify_checkpoint", "latest_step",
           "latest_valid_step", "list_steps"]
