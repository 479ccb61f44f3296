"""Latent-space editing of the port: InterFaceGAN boundary walks."""

from .interfacegan import FaceEditor, pseudo_align_latents, train_boundary

__all__ = ["FaceEditor", "pseudo_align_latents", "train_boundary"]
