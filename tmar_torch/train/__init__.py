"""GAN train and eval steps."""

from tmar_torch.train.steps import (
    GANTrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = ["GANTrainState", "create_train_state", "make_eval_step", "make_train_step"]
