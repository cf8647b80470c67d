from repro_torch.checkpoint.io import (CheckpointCorruptError, latest_step,
                                       list_checkpoints, restore_checkpoint,
                                       save_checkpoint)

__all__ = ["CheckpointCorruptError", "latest_step", "list_checkpoints",
           "restore_checkpoint", "save_checkpoint"]
