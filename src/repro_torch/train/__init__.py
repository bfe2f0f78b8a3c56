"""Training substrate: step builder with microbatching + AdamW (twin of
``repro.train``)."""
from repro_torch.train.step import (
    TRAIN_CALL, TrainConfig, build_train_step, grads_with_microbatching,
    make_loss, train_step_fn,
)
__all__ = ["TRAIN_CALL", "TrainConfig", "build_train_step",
           "grads_with_microbatching", "make_loss", "train_step_fn"]
