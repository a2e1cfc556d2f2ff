"""GAN train and eval steps, the configuration and the Trainer around them."""

from tmar_torch.train.config import TrainConfig, config_path, load_config
from tmar_torch.train.steps import (
    GANTrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from tmar_torch.train.trainer import Trainer
from tmar_torch.train.variants import resolve_variant

__all__ = [
    "GANTrainState",
    "TrainConfig",
    "Trainer",
    "config_path",
    "create_train_state",
    "load_config",
    "make_eval_step",
    "make_train_step",
    "resolve_variant",
]
