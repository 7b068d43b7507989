"""Checkpoints: atomic pytree snapshots (`io`), in the reference's file
format, and whole-run checkpoint/resume for `run_fl` (`run_state`).
Counterpart of `repro/checkpoint`."""
from repro_torch.checkpoint.io import load_pytree, save_pytree  # noqa: F401
from repro_torch.checkpoint.run_state import (  # noqa: F401
    CheckpointSpec, checkpoint_path, fast_forward_sampler, latest_checkpoint,
    list_checkpoints, prune_checkpoints, restore_run, save_run)
