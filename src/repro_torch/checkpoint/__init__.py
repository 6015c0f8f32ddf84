from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore, restore_latest, save,
                                         valid_steps)
from repro_torch.checkpoint.metrics import CheckpointMetrics

__all__ = ["CheckpointManager", "CheckpointMetrics", "latest_step",
           "restore", "restore_latest", "save", "valid_steps"]
