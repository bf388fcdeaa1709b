"""Checkpointing (twin of `repro.checkpoint`, on its on-disk format)."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_pytree,
    save_pytree,
)
