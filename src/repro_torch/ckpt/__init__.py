from repro_torch.ckpt.checkpoint import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
