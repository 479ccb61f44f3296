"""StyleCLIP global directions in StyleSpace.

Counterpart of the JAX package's `editing/styleclip_global.py` (reference
editing/styleclip_global_directions/): `StyleCLIPGlobalDirection` (a text
Δi from prompt templates, ``delta_s = delta_i_c @ delta_i``, the β
threshold, max-normalised and scaled per channel by the S std),
`compute_s_statistics` (100k z → W2S → per-channel mean and std, and the
mean input transform) and `compute_delta_i_c` (±5σ per-channel
perturbations → CLIP image-feature deltas). A run of channels batches onto
the batch axis (`delta_i_c_batch`), as in the JAX package; the reference
renders one image a call.

The flat channel order is the JAX package's: its jitted ``w2s`` hands the
StyleSpace dict back through a pytree, whose keys come back sorted
(``L0_…``, ``L10_…`` … ``L14_…``, ``L1_…`` … ``L9_…``, ``input``).
`compute_s_statistics` returns its dicts in that order, and every flat
channel vector (``delta_i_c``'s rows, `features_channels_to_s`) walks the
dicts in theirs, so the files are the JAX package's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import fp32_matmul
from ..models.backbones.clip import CLIP, clip_preprocess_from_synth

# Standard CLIP prompt-ensemble templates (OpenAI's public ImageNet set is
# the reference's templates.txt; pass the full file via `templates`).
DEFAULT_TEMPLATES = (
    "a photo of a {}.",
    "a photo of the {}.",
    "a close-up photo of a {}.",
    "a cropped photo of a {}.",
    "a good photo of a {}.",
    "a bad photo of a {}.",
    "a bright photo of a {}.",
    "a dark photo of a {}.",
    "a photo of one {}.",
    "a photo of a nice {}.",
    "a photo of a weird {}.",
    "a blurry photo of a {}.",
    "a pixelated photo of a {}.",
    "a jpeg corrupted photo of a {}.",
    "a black and white photo of a {}.",
    "a photo of a cool {}.",
    "a photo of a small {}.",
    "a photo of a big {}.",
)


def load_templates(path: Optional[str] = None) -> Sequence[str]:
    if path and Path(path).exists():
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]
    return DEFAULT_TEMPLATES


def s_key_order(keys) -> List[str]:
    """The JAX package's order of StyleSpace keys (its pytree's: sorted)."""
    return sorted(keys)


def features_channels_to_s(channels: torch.Tensor, std: Mapping[str, torch.Tensor],
                           example_s: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Flat channel vector → per-layer StyleSpace dict ``[1, n]``, scaled by
    the S std, in ``example_s``'s order."""
    result = {}
    start = 0
    for key, ref in example_s.items():
        n = ref.shape[-1]
        result[key] = (channels[start:start + n] * std[key])[None]
        start += n
    return result


class StyleCLIPGlobalDirection:
    """Text-driven StyleSpace edits through the precomputed ``delta_i_c``.

    ``clip_model`` is a port `CLIP` (its weights in it); the statistics go
    to its device.
    """

    def __init__(self, delta_i_c: np.ndarray, s_std: Mapping[str, np.ndarray],
                 templates: Sequence[str], s_avg: Mapping[str, np.ndarray],
                 clip_model: CLIP, tokenizer):
        device = next(clip_model.parameters()).device

        def on_device(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)

        self.delta_i_c = on_device(delta_i_c)
        self.s_std = {k: on_device(v) for k, v in s_std.items()}
        self.s_avg = {k: on_device(v) for k, v in s_avg.items()}
        self.templates = list(templates)
        self.clip = clip_model
        self.tokenizer = tokenizer

    @torch.no_grad()
    def _averaged_text_features(self, prompts: Sequence[str]) -> torch.Tensor:
        feats = []
        for prompt in prompts:
            texts = [t.format(prompt) for t in self.templates]
            emb = self.clip.encode_text(self.tokenizer.tokenize(texts))
            emb = emb / emb.norm(dim=-1, keepdim=True)
            mean = emb.mean(dim=0)
            feats.append(mean / mean.norm())
        return torch.stack(feats)

    def get_delta_i(self, prompts: Sequence[str]) -> torch.Tensor:
        f = self._averaged_text_features(prompts)
        delta_t = f[0] - f[1]
        return delta_t / delta_t.norm()

    def get_delta_s(self, neutral_text: str, target_text: str, beta: float
                    ) -> Dict[str, torch.Tensor]:
        delta_i = self.get_delta_i([target_text, neutral_text])
        with fp32_matmul():  # r_c meets β: no TF32 here either
            r_c = self.delta_i_c @ delta_i
        delta_s = torch.where(r_c.abs() < beta, torch.zeros_like(r_c), r_c)
        max_val = delta_s.abs().max()
        if max_val > 0:
            delta_s = delta_s / max_val
        return features_channels_to_s(delta_s, self.s_std, self.s_avg)


def apply_delta_s(all_s: Mapping[str, torch.Tensor], delta_s: Mapping[str, torch.Tensor],
                  alpha: float) -> Dict[str, torch.Tensor]:
    """all_s + α·Δs, leaving the ``input`` transform as it is (reference
    edit.py:150)."""
    out = dict(all_s)
    for key, d in delta_s.items():
        if key == "input":
            continue
        out[key] = all_s[key] + alpha * d
    return out


# ------------------------------------------------------------- preprocess

@torch.no_grad()
def compute_s_statistics(
    generator, num_images: int = 100_000, batch: int = 1024, truncation_psi: float = 0.5,
    truncation_cutoff: int = 8, seed: int = 0,
) -> Tuple[dict, Dict[str, np.ndarray], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Sample z → map → W2S on the generator's device; return (mean input
    transform, s_mean, s_std, the first 1,000 samples), each dict in the
    JAX package's key order.

    z is numpy's ``RandomState(seed)``, as in the JAX package. The moments
    sum in float64 on the device (only the first 1,000 samples come to the
    host), then mean and std are formed as in the JAX package:
    ``std = sqrt(max(E[x²] − float32(mean)², 0) + 1e-12)``.
    """
    rnd = np.random.RandomState(seed)
    device = next(generator.parameters()).device
    moments = None
    first_1k: Dict[str, list] = {}
    collected = 0
    for start in range(0, num_images, batch):
        n = min(batch, num_images - start)
        z = torch.as_tensor(rnd.randn(n, generator.cfg.z_dim).astype(np.float32), device=device)
        ws = generator.map(z, truncation_psi=truncation_psi,
                           truncation_cutoff=truncation_cutoff)
        all_s = generator.w2s(ws)
        if moments is None:
            moments = {k: [0.0, 0.0] for k in s_key_order(all_s)}
        for k in moments:
            v = all_s[k].double()
            moments[k][0] = moments[k][0] + v.sum(dim=0)
            moments[k][1] = moments[k][1] + v.square().sum(dim=0)
            if collected < 1000:
                first_1k.setdefault(k, []).append(all_s[k][:1000 - collected].cpu().numpy())
        collected += n

    s_mean = {k: (m[0] / num_images).cpu().numpy().astype(np.float32)
              for k, m in moments.items()}
    s_std = {
        k: np.sqrt(np.maximum(m[1].cpu().numpy() / num_images - np.square(s_mean[k]), 0)
                   + 1e-12).astype(np.float32)
        for k, m in moments.items()
    }
    s_1k = {k: np.concatenate(v)[:1000] for k, v in first_1k.items()}

    t = s_1k["input"]
    transform = {"theta": float(np.arccos(np.clip(t[:, 0], -1, 1)).mean()),
                 "x": float(t[:, 2].mean()), "y": float(t[:, 3].mean())}
    return transform, s_mean, s_std, s_1k


@torch.no_grad()
def delta_i_c_batch(
    generator, clip_model: CLIP, base: Mapping[str, torch.Tensor],
    s_mean: Mapping[str, np.ndarray], s_std: Mapping[str, np.ndarray], layer: str,
    channels: Sequence[int], manipulation_strength: float = 5.0, impl: str = "auto",
) -> torch.Tensor:
    """One batch of `compute_delta_i_c`: the channels ``channels`` of
    ``layer``, each set to ``mean ∓ strength·std`` in every sample of
    ``base`` (``{key: [num_samples, n]}`` on the generator's device), render
    ``len(channels) × 2 × num_samples`` images in one synthesis, CLIP-encode
    them → each channel's normalised feature delta, ``[len(channels),
    embed_dim]``. ``impl="ref"`` renders through the plain filtered lrelu."""
    num_samples = base[layer].shape[0]
    rows = [(ci, direction) for ci in channels
            for direction in (-manipulation_strength, manipulation_strength)]
    batched = {k: v.repeat(len(rows), 1) for k, v in base.items()}
    for row, (ci, direction) in enumerate(rows):
        val = s_mean[layer][ci] + direction * s_std[layer][ci]
        batched[layer][row * num_samples:(row + 1) * num_samples, ci] = float(val)
    imgs = generator.synthesize(None, all_s=batched, impl=impl)
    feats = clip_model.encode_image(clip_preprocess_from_synth(imgs, clip_model.image_resolution))
    feats = feats.reshape(len(channels), 2, num_samples, -1)
    f = feats / feats.norm(dim=-1, keepdim=True)
    d = f[:, 1] - f[:, 0]
    d = d / d.norm(dim=-1, keepdim=True)
    d = d.mean(dim=1)
    return d / d.norm(dim=-1, keepdim=True)


def compute_delta_i_c(
    generator, clip_model: CLIP, s_samples: Mapping[str, np.ndarray],
    s_mean: Mapping[str, np.ndarray], s_std: Mapping[str, np.ndarray], num_samples: int = 1,
    manipulation_strength: float = 5.0, channels_per_batch: int = 8,
) -> np.ndarray:
    """±strength·σ per-channel S perturbations → normalised CLIP deltas
    ``[channels, embed_dim]``, one row per channel in ``s_samples``' key
    order; `delta_i_c_batch` over runs of ``channels_per_batch`` channels."""
    device = next(generator.parameters()).device
    base = {k: torch.as_tensor(np.asarray(v[:num_samples], np.float32), device=device)
            for k, v in s_samples.items()}
    deltas = []
    for layer in s_samples:
        n_channels = base[layer].shape[-1]
        for c0 in range(0, n_channels, channels_per_batch):
            cs = list(range(c0, min(c0 + channels_per_batch, n_channels)))
            deltas.append(delta_i_c_batch(generator, clip_model, base, s_mean, s_std, layer,
                                          cs, manipulation_strength).cpu().numpy())
    return np.concatenate(deltas, axis=0).astype(np.float32)
