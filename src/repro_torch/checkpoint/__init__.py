"""Checkpoints (counterpart of ``repro.checkpoint``)."""
from .checkpoint import (CheckpointManager, latest_step, load_pytree,
                         save_pytree)
