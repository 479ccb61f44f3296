"""Field-of-view expansion through shifted Fourier-feature transforms.

Counterpart of the JAX package's `utils/fov_expansion.py` (reference
utils/fov_expansion.py `Expander`): the frame and its edge- and
corner-shifted views, stitched into a (res + Δ)² canvas. The reference runs
up to 9 synthesis calls a frame; here every present view runs in ONE
batched `synthesize` with per-view transforms ``[views·N, 3, 3]``, and the
stitch is slice assignment. The ws are tiled per view, so the style RMS
over the batch is the one of ``ws`` alone.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .common import make_transform

SLOTS = ("center", "left", "top", "right", "bottom",
         "top_left", "top_right", "bottom_right", "bottom_left")


class Expander:
    """Expanded canvases from a port `Generator` (``synthesize``) at ``resolution``."""

    def __init__(self, generator, resolution: int):
        self.G = generator
        self.res = resolution

    def transforms(self, pr: int, pl: int, pt: int, pb: int) -> Dict[str, Optional[np.ndarray]]:
        """Each slot's inverse shift (None where its margins are 0)."""
        res = self.res
        t = {
            "center": make_transform((0, 0), 0),
            "left": make_transform((pl / res, 0), 0) if pl else None,
            "right": make_transform((-pr / res, 0), 0) if pr else None,
            "top": make_transform((0, pt / res), 0) if pt else None,
            "bottom": make_transform((0, -pb / res), 0) if pb else None,
            "top_left": make_transform((pl / res, pt / res), 0) if pl and pt else None,
            "top_right": make_transform((-pr / res, pt / res), 0) if pr and pt else None,
            "bottom_right": make_transform((-pr / res, -pb / res), 0) if pr and pb else None,
            "bottom_left": make_transform((pl / res, -pb / res), 0) if pl and pb else None,
        }
        return {k: (np.linalg.inv(v) if v is not None else None) for k, v in t.items()}

    def views(self, ws: torch.Tensor, landmark_t: np.ndarray, pixels_right: int = 0,
              pixels_left: int = 0, pixels_top: int = 0, pixels_bottom: int = 0,
              impl: str = "auto") -> Dict[str, torch.Tensor]:
        """Every present slot's full ``[N, res, res, C]`` view, from one
        `synthesize` over (present slots × batch)."""
        assert landmark_t is not None
        transforms = self.transforms(pixels_right, pixels_left, pixels_top, pixels_bottom)
        active = [k for k in SLOTS if transforms[k] is not None]
        n = ws.shape[0]
        stacked = torch.as_tensor(np.stack([np.asarray(landmark_t) @ transforms[k]
                                            for k in active]), dtype=torch.float32,
                                  device=ws.device)
        imgs = self.G.synthesize(ws.repeat(len(active), 1, 1),
                                 transform=stacked.repeat_interleave(n, dim=0), impl=impl)
        return {k: imgs[i * n:(i + 1) * n] for i, k in enumerate(active)}

    @torch.no_grad()
    def generate_expanded_image(self, ws: torch.Tensor, landmark_t: np.ndarray,
                                pixels_right: int = 0, pixels_left: int = 0,
                                pixels_top: int = 0, pixels_bottom: int = 0,
                                impl: str = "auto") -> torch.Tensor:
        """ws ``[N, num_ws, w_dim]``, landmark_t ``[3, 3]`` → the NHWC canvas
        ``[N, top + res + bottom, left + res + right, C]``."""
        res = self.res
        pr, pl, pt, pb = pixels_right, pixels_left, pixels_top, pixels_bottom
        v = self.views(ws, landmark_t, pr, pl, pt, pb, impl=impl)
        center = v["center"]
        canvas = center.new_zeros((ws.shape[0], pt + res + pb, pl + res + pr, center.shape[-1]))
        canvas[:, pt:pt + res, pl:pl + res] = center
        if pl:
            canvas[:, pt:pt + res, :pl] = v["left"][:, :, :pl]
        if pt:
            canvas[:, :pt, pl:pl + res] = v["top"][:, :pt, :]
        if pr:
            canvas[:, pt:pt + res, pl + res:] = v["right"][:, :, res - pr:]
        if pb:
            canvas[:, pt + res:, pl:pl + res] = v["bottom"][:, res - pb:, :]
        if pt and pl:
            canvas[:, :pt, :pl] = v["top_left"][:, :pt, :pl]
        if pt and pr:
            canvas[:, :pt, pl + res:] = v["top_right"][:, :pt, res - pr:]
        if pb and pr:
            canvas[:, pt + res:, pl + res:] = v["bottom_right"][:, res - pb:, res - pr:]
        if pb and pl:
            canvas[:, pt + res:, :pl] = v["bottom_left"][:, res - pb:, :pl]
        return canvas
