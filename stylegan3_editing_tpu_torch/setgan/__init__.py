"""SetGAN of the port: the set transformer, the set-conditioned generator
and the multi-set data sampler.

Counterparts of the JAX package's `setgan/set_transformer.py`,
`setgan/model.py` and `setgan/dataset.py`. The discriminator, the loss,
DiffAugment/ADA, the metrics and the training loop are not ported yet
(ROADMAP Queue 1 #9).
"""

from .dataset import (ClassImageDataset, ImageMultiSetGenerator, SafeClassImageDataset,
                      build_datasets)
from .model import (SetGAN, StyleAttention, StyleConcat, make_stem, to_images, to_imgset,
                    to_set)
from .set_transformer import (MHA, PMA, MultiSetAttentionBlock, MultiSetTransformerEncoder,
                              SetAttentionBlock, SetDecoderBlock, SetEncoderBlock,
                              SetTransformerDecoder, SetTransformerEncoder, masked_softmax)

__all__ = ["ClassImageDataset", "ImageMultiSetGenerator", "SafeClassImageDataset",
           "build_datasets", "SetGAN", "StyleAttention", "StyleConcat", "make_stem",
           "to_images", "to_imgset", "to_set", "MHA", "PMA", "MultiSetAttentionBlock",
           "MultiSetTransformerEncoder", "SetAttentionBlock", "SetDecoderBlock",
           "SetEncoderBlock", "SetTransformerDecoder", "SetTransformerEncoder",
           "masked_softmax"]
