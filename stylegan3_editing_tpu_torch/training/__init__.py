"""Training options of the port (the training loops are not ported yet)."""

from .options import E4eTrainOptions, TrainOptions

__all__ = ["TrainOptions", "E4eTrainOptions"]
