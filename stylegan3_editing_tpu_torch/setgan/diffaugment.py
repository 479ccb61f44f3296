"""DiffAugment (colour, translation, cutout) on NHWC images, draws apart.

Counterpart of the JAX package's `setgan/diffaugment.py` (Zhao et al.
2020, the policy ``"color,translation,cutout"`` of the projected
discriminator). Each op is split in two: `draw_augment` draws its random
numbers per image from a `torch.Generator` (on the images' device), and
`apply_augment` applies given draws. So a caller can feed in the draws
another run made (the JAX package's, from its key) and get its
augmentation. The draws of one image batch, by op:

- ``brightness`` ``[N]``: U(0, 1) − 0.5, added;
- ``saturation`` ``[N]``: 2·U(0, 1), scales each pixel's distance to its
  channel mean;
- ``contrast`` ``[N]``: U(0, 1) + 0.5, scales the distance to the image mean;
- ``tx``, ``ty`` ``[N]``: integer shifts in [−⌊H/8 + ½⌋, ⌊H/8 + ½⌋] of rows
  and columns, zeros shifted in;
- ``cy``, ``cx`` ``[N]``: the centre of a zeroed square of half the side.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

POLICY = "color,translation,cutout"
TRANSLATION_RATIO, CUTOUT_RATIO = 0.125, 0.5
_OPS = {"color": ("brightness", "saturation", "contrast"), "translation": ("translation",),
        "cutout": ("cutout",)}


def _ops(policy: str):
    return [op for name in policy.split(",") for op in _OPS[name.strip()]]


def draw_augment(n: int, h: int, w: int, generator: Optional[torch.Generator] = None,
                 device=None, policy: str = POLICY) -> Dict[str, torch.Tensor]:
    """The random numbers ``policy`` takes for ``n`` images of ``h × w``."""
    device = generator.device if generator is not None and device is None else device
    kw = dict(generator=generator, device=device)
    draws: Dict[str, torch.Tensor] = {}
    for op in _ops(policy):
        if op == "brightness":
            draws["brightness"] = torch.rand(n, **kw) - 0.5
        elif op == "saturation":
            draws["saturation"] = torch.rand(n, **kw) * 2
        elif op == "contrast":
            draws["contrast"] = torch.rand(n, **kw) + 0.5
        elif op == "translation":
            sh, sw = int(h * TRANSLATION_RATIO + 0.5), int(w * TRANSLATION_RATIO + 0.5)
            draws["tx"] = torch.randint(-sh, sh + 1, (n,), **kw)
            draws["ty"] = torch.randint(-sw, sw + 1, (n,), **kw)
        else:
            ch, cw = int(h * CUTOUT_RATIO + 0.5), int(w * CUTOUT_RATIO + 0.5)
            draws["cy"] = torch.randint(0, h + (1 - ch % 2), (n,), **kw)
            draws["cx"] = torch.randint(0, w + (1 - cw % 2), (n,), **kw)
    return draws


def translate(x: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
              ratio: float = TRANSLATION_RATIO) -> torch.Tensor:
    """Shift each image by ``tx`` rows and ``ty`` columns, zeros shifted in."""
    n, h, w, _ = x.shape
    sh, sw = int(h * ratio + 0.5), int(w * ratio + 0.5)
    pad = torch.nn.functional.pad(x, (0, 0, sw, sw, sh, sh))
    rows = torch.arange(h, device=x.device)[None, :] + (sh + tx.to(x.device))[:, None]
    cols = torch.arange(w, device=x.device)[None, :] + (sw + ty.to(x.device))[:, None]
    batch = torch.arange(n, device=x.device)[:, None, None]
    return pad[batch, rows[:, :, None], cols[:, None, :]]


def cutout(x: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
           ratio: float = CUTOUT_RATIO) -> torch.Tensor:
    """Zero a ``⌊H/2 + ½⌋ × ⌊W/2 + ½⌋`` square around (``cy``, ``cx``) of each image."""
    _, h, w, _ = x.shape
    ch, cw = int(h * ratio + 0.5), int(w * ratio + 0.5)
    cy, cx = cy.to(x.device)[:, None, None], cx.to(x.device)[:, None, None]
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    inside = ((yy >= cy - ch // 2) & (yy < cy + (ch + 1) // 2)
              & (xx >= cx - cw // 2) & (xx < cx + (cw + 1) // 2))
    return x * (1.0 - inside.to(x.dtype))[:, :, :, None]


def apply_augment(x: torch.Tensor, draws: Dict[str, torch.Tensor],
                  policy: str = POLICY) -> torch.Tensor:
    """``x`` ``[N, H, W, C]`` in [−1, 1] augmented with ``draws`` (from
    `draw_augment`), the ops in the policy's order."""
    def per_image(v):
        return v.to(x.device, x.dtype)[:, None, None, None]

    for op in _ops(policy):
        if op == "brightness":
            x = x + per_image(draws["brightness"])
        elif op == "saturation":
            mean = x.mean(dim=-1, keepdim=True)
            x = (x - mean) * per_image(draws["saturation"]) + mean
        elif op == "contrast":
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            x = (x - mean) * per_image(draws["contrast"]) + mean
        elif op == "translation":
            x = translate(x, draws["tx"], draws["ty"])
        else:
            x = cutout(x, draws["cy"], draws["cx"])
    return x
