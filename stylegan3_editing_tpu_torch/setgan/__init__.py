"""SetGAN of the port: the set transformer, the set-conditioned generator,
the multi-set data sampler, the projected set discriminator, DiffAugment
and ADA, the loss, the trainer and the conditional FID.

Counterparts of the JAX package's `setgan/` modules.
"""

from .ada import AdaController, AdaState, apply_ada
from .dataset import (ClassImageDataset, ImageMultiSetGenerator, SafeClassImageDataset,
                      build_datasets)
from .diffaugment import apply_augment, draw_augment
from .discriminator import (BACKBONES, FeatureProjector, MultiScaleD, MultiSetComparator,
                            ProjectedSetDiscriminator, SingleDisc, TinyFeatures,
                            backbone_fixed_res, projector_param_mask, resolve_backbone)
from .loss import (SetGANLossConfig, blur_images, blur_sigma_at, d_main_loss, g_main_loss,
                   path_length_penalty)
from .metrics import (ConditionalFID, ConditionalMetrics, FeatureStats, frechet_distance,
                      stats_cache_file)
from .model import (SetGAN, StyleAttention, StyleConcat, make_stem, to_images, to_imgset,
                    to_set)
from .set_transformer import (MHA, PMA, MultiSetAttentionBlock, MultiSetTransformerEncoder,
                              SetAttentionBlock, SetDecoderBlock, SetEncoderBlock,
                              SetTransformerDecoder, SetTransformerEncoder, masked_softmax)
from .training_loop import SetGANTrainConfig, SetGANTrainer

__all__ = ["AdaController", "AdaState", "apply_ada", "ClassImageDataset",
           "ImageMultiSetGenerator", "SafeClassImageDataset", "build_datasets", "apply_augment",
           "draw_augment", "BACKBONES", "FeatureProjector", "MultiScaleD",
           "MultiSetComparator", "ProjectedSetDiscriminator", "SingleDisc", "TinyFeatures",
           "backbone_fixed_res", "projector_param_mask", "resolve_backbone",
           "SetGANLossConfig", "blur_images", "blur_sigma_at", "d_main_loss", "g_main_loss",
           "path_length_penalty", "ConditionalFID", "ConditionalMetrics", "FeatureStats",
           "frechet_distance", "stats_cache_file", "SetGAN", "StyleAttention", "StyleConcat", "make_stem",
           "to_images", "to_imgset", "to_set", "MHA", "PMA", "MultiSetAttentionBlock",
           "MultiSetTransformerEncoder", "SetAttentionBlock", "SetDecoderBlock",
           "SetEncoderBlock", "SetTransformerDecoder", "SetTransformerEncoder",
           "masked_softmax", "SetGANTrainConfig", "SetGANTrainer"]
