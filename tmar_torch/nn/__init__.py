"""The generator's and the discriminators' modules, the baselines and the
dual-domain DuDo network."""

from tmar_torch.nn.baselines import (
    BAFResNet,
    DCGANCritic,
    DCGANDiscriminator,
    DCGANGenerator,
    DenoisingTransformer,
    RedCNN,
)
from tmar_torch.nn.dudo import DuDoMARNet
from tmar_torch.nn.ngswin import NGswin
from tmar_torch.nn.patchgan import (
    ConditionalDiscriminator,
    MultiScaleDiscriminator,
    SingleScaleDiscriminator,
)

__all__ = [
    "BAFResNet",
    "ConditionalDiscriminator",
    "DCGANCritic",
    "DCGANDiscriminator",
    "DCGANGenerator",
    "DenoisingTransformer",
    "DuDoMARNet",
    "RedCNN",
    "MultiScaleDiscriminator",
    "NGswin",
    "SingleScaleDiscriminator",
]
