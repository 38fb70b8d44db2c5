"""The train, prefill and serve steps and the trainer."""
from .trainstep import (  # noqa: F401
    TrainState,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    place_on_mesh,
)
from .trainer import SimulatedFailure, Trainer, TrainerConfig  # noqa: F401
