"""repro_torch.training — optimizer, train step, checkpointing,
compression (port of `repro.training`), and the trees' leaf order."""
from . import checkpoint, compression, optimizer, train_step, tree

__all__ = ["checkpoint", "compression", "optimizer", "train_step", "tree"]
