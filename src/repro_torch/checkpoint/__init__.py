from repro_torch.checkpoint.checkpointer import CheckpointReader, Checkpointer

__all__ = ["CheckpointReader", "Checkpointer"]
