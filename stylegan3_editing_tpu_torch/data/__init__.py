"""Host-side data pipeline (numpy, PIL imported where an image is read)."""

from .images_dataset import BatchIterator, ImagesDataset, make_dataset
from .transforms import encode_transforms

__all__ = ["encode_transforms", "ImagesDataset", "BatchIterator", "make_dataset"]
