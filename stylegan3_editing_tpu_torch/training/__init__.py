"""ReStyle encoder training of the port: options, Ranger, the latent
discriminator and its pool, and the coach (the StyleCLIP mapper's coach is
in `editing`)."""

from .coach import Coach
from .latent_discriminator import LatentCodesDiscriminator, LatentCodesPool
from .options import E4eTrainOptions, TrainOptions
from .ranger import Ranger, ranger

__all__ = ["Coach", "TrainOptions", "E4eTrainOptions", "LatentCodesDiscriminator",
           "LatentCodesPool", "Ranger", "ranger"]
