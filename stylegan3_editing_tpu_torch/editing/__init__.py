"""Latent-space editing of the port: InterFaceGAN boundary walks and their
attribute scorers, StyleCLIP global directions and the StyleCLIP mapper."""

from .interfacegan import FaceEditor, pseudo_align_latents, train_boundary

__all__ = ["FaceEditor", "pseudo_align_latents", "train_boundary"]
