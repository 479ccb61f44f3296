"""Training options and the Ranger optimizer of the port (the ReStyle coach
is not ported yet; the StyleCLIP mapper's coach is in `editing`)."""

from .options import E4eTrainOptions, TrainOptions
from .ranger import Ranger, ranger

__all__ = ["TrainOptions", "E4eTrainOptions", "Ranger", "ranger"]
