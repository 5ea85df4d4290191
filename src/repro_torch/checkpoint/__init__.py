from repro_torch.checkpoint.checkpointing import (
    AsyncCheckpointer, Checkpointer, CheckpointInfo,
)

__all__ = ["AsyncCheckpointer", "Checkpointer", "CheckpointInfo"]
