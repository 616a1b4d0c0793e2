"""Training: AdamW with fp32 moments, the train loop and checkpoints."""
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWState, adamw_init, adamw_update, cosine_schedule,
)
from repro_torch.training.train_loop import TrainLoopConfig, train  # noqa: F401
