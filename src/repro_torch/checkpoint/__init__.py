"""Checkpoints in the JAX package's ``step_<n>/arrays.npz`` layout."""
from .manager import (  # noqa: F401
    CheckpointManager,
    available_steps,
    flatten,
    from_numpy,
    load_arrays,
    save_pytree,
    to_numpy,
)
