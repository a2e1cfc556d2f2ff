"""The generator's and the discriminators' modules."""

from tmar_torch.nn.ngswin import NGswin
from tmar_torch.nn.patchgan import (
    ConditionalDiscriminator,
    MultiScaleDiscriminator,
    SingleScaleDiscriminator,
)

__all__ = [
    "ConditionalDiscriminator",
    "MultiScaleDiscriminator",
    "NGswin",
    "SingleScaleDiscriminator",
]
