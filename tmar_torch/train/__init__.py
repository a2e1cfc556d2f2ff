"""GAN train and eval steps, the configuration and the Trainer around them,
the fine-tune engine and the DCGAN tutorial loop."""

from tmar_torch.train.config import TrainConfig, config_path, load_config
from tmar_torch.train.dcgan import train_dcgan
from tmar_torch.train.finetune import (
    FinetuneState,
    FinetuneWeights,
    create_finetune_state,
    finetune,
    make_finetune_step,
)
from tmar_torch.train.steps import (
    GANTrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from tmar_torch.train.trainer import Trainer
from tmar_torch.train.variants import ABLATIONS, VARIANTS, resolve_variant

__all__ = [
    "ABLATIONS",
    "FinetuneState",
    "FinetuneWeights",
    "GANTrainState",
    "TrainConfig",
    "Trainer",
    "config_path",
    "VARIANTS",
    "create_finetune_state",
    "create_train_state",
    "finetune",
    "load_config",
    "make_eval_step",
    "make_finetune_step",
    "make_train_step",
    "resolve_variant",
    "train_dcgan",
]
