"""ProjectedSetGANLoss: hinge D / −mean G over multi-scale set logits.

Counterpart of the JAX package's `setgan/loss.py` (reference setgan/loss.py):
the G loss is Σ −mean(logits) over the logit columns, the D loss
Σ mean relu(1 + fake) + Σ mean relu(1 − real); D sees images blurred by a
Gaussian whose σ fades from ``blur_init_sigma`` to 0 over
``blur_fade_kimg`` (`blur_images` runs the port's `upfirdn2d`, a
separable FIR); `path_length_penalty` is StyleGAN2's path-length
regulariser on a function of the style latents.

The trainer does not run the path-length term yet: it needs second
derivatives through the generator, which `device.conv2d`'s backward and
the filtered-lrelu kernels' backward do not give (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.upfirdn2d import upfirdn2d
from .model import to_images, to_set


@dataclasses.dataclass(frozen=True)
class SetGANLossConfig:
    blur_init_sigma: float = 0.0
    blur_fade_kimg: float = 0.0
    pl_weight: float = 0.0
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    pl_start_nimg: float = 1e6


def blur_sigma_at(cur_nimg, cfg: SetGANLossConfig) -> float:
    """The blur σ after ``cur_nimg`` images: linear fade to 0 over ``blur_fade_kimg``."""
    if cfg.blur_fade_kimg <= 1:
        return 0.0
    return max(1 - cur_nimg / (cfg.blur_fade_kimg * 1e3), 0) * cfg.blur_init_sigma


def blur_filter(blur_sigma: float) -> Optional[np.ndarray]:
    """The normalised 1-D taps 2^(−(t/σ)²), t in [−⌊3σ⌋, ⌊3σ⌋]; None for no blur."""
    blur_size = int(np.floor(blur_sigma * 3))
    if blur_size <= 0:
        return None
    taps = np.arange(-blur_size, blur_size + 1) / blur_sigma
    f = np.exp2(-np.square(taps)).astype(np.float32)
    return f / f.sum()


def blur_images(imgs: torch.Tensor, blur_sigma: float) -> torch.Tensor:
    """Gaussian blur of set images ``[B, S, H, W, C]`` (same size out)."""
    f = blur_filter(blur_sigma)
    if f is None:
        return imgs
    blurred = upfirdn2d(to_images(imgs), f, padding=len(f) // 2)
    return to_set(blurred, imgs.shape[0])


def g_main_loss(logits: torch.Tensor) -> torch.Tensor:
    """Generator: maximise the logits → −mean per column, summed."""
    return (-logits.mean(dim=0)).sum()


def d_main_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Hinge discriminator loss over the concatenated multi-scale logits,
    and its statistics (tensors on the logits' device)."""
    loss_fake = torch.relu(1 + fake_logits).mean(dim=0).sum()
    loss_real = torch.relu(1 - real_logits).mean(dim=0).sum()
    loss = loss_fake + loss_real
    stats = {
        "Loss/scores/fake": fake_logits.mean(),
        "Loss/scores/real": real_logits.mean(),
        "Loss/signs/fake": fake_logits.sign().mean(),
        "Loss/signs/real": real_logits.sign().mean(),
        "Loss/D/loss": loss,
    }
    return loss, stats


def path_length_penalty(run_g_from_ws: Callable[[torch.Tensor], torch.Tensor],
                        ws: torch.Tensor, pl_mean: torch.Tensor, cfg: SetGANLossConfig,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """StyleGAN2's path-length regularisation of ``run_g_from_ws``.

    ``ws`` ``[N, n_styles, w_dim]``; the images' last three axes are
    ``H, W, C``. The pull-back of image-space noise (N(0, 1)/√(HW), drawn
    from ``generator`` unless ``noise`` is given) onto ``ws`` gives each
    sample's path length; the penalty is the mean squared distance to the
    moving mean. Returns (penalty · pl_weight, the new mean, detached,
    stats); the penalty stays differentiable (second order through
    ``run_g_from_ws``)."""
    ws = ws if ws.requires_grad else ws.detach().requires_grad_(True)
    imgs = run_g_from_ws(ws)
    h, w = imgs.shape[-3], imgs.shape[-2]
    if noise is None:
        noise = torch.randn(imgs.shape, generator=generator, device=imgs.device)
    noise = noise / math.sqrt(h * w)
    (pl_grads,) = torch.autograd.grad((imgs * noise).sum(), ws, create_graph=True)
    pl_lengths = pl_grads.square().sum(-1).mean(-1).sqrt().reshape(-1)
    new_pl_mean = pl_mean + cfg.pl_decay * (pl_lengths.mean() - pl_mean)
    penalty = (pl_lengths - new_pl_mean).square().mean()
    return penalty * cfg.pl_weight, new_pl_mean.detach(), {"Loss/pl_penalty": penalty}
