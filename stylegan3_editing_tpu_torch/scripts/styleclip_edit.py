"""Text-driven StyleSpace editing with StyleCLIP global directions (CLI).

The port of the JAX package's `scripts/styleclip_edit.py` (reference
editing/styleclip_global_directions/edit.py), with its options plus
``--device``: inverted latents → `w2s` → Δs (neutral → target text, β) →
α·Δs → `synthesize(all_s=…)`, one synthesis per (α, β), written to
``<exp_dir>/<stem>_a<α>_b<β>.png``. The latents are a ReStyle
``latents.npy`` (name → ``[n_iters, n_styles, 512]``, the last iteration
edited), the decoder `load_encoder`'s; CLIP is an OpenAI state dict
(``--clip_weights``; seeded random without it) and the tokenizer the BPE
vocabulary (``--bpe_path``, else `configs.model_paths`). It runs on the
CUDA card unless ``--device cpu``, under `torch.inference_mode`.

    python -m stylegan3_editing_tpu_torch.scripts.styleclip_edit \\
        --checkpoint_path CKPT --latents_path latents.npy --stats_path STATS \\
        --clip_weights clip.pt --bpe_path bpe.txt.gz --exp_dir OUT [--device cpu]
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs import model_paths
from ..device import resolve_device
from ..editing.styleclip_global import StyleCLIPGlobalDirection, apply_delta_s, load_templates
from ..models.backbones.clip import CLIP, SimpleTokenizer, load_clip_weights
from ..utils.cli import parse_dataclass
from ..utils.common import tensor2im
from ..utils.inference_utils import load_encoder


@dataclasses.dataclass
class StyleCLIPEditOptions:
    exp_dir: str = "./experiments/styleclip_edit"
    checkpoint_path: Optional[str] = None
    latents_path: str = "./latents.npy"
    stats_path: str = "./styleclip_stats"
    clip_weights: Optional[str] = None
    bpe_path: Optional[str] = None
    neutral_text: str = "face"
    target_text: str = "smiling face"
    alphas: List[float] = dataclasses.field(default_factory=lambda: [2.0])
    betas: List[float] = dataclasses.field(default_factory=lambda: [0.11])
    n_images: Optional[int] = None
    templates_path: Optional[str] = None
    device: Optional[str] = None  # cuda unless "cpu"


@torch.inference_mode()
def run(opts: StyleCLIPEditOptions) -> Path:
    device = resolve_device(opts.device)
    out = Path(opts.exp_dir)
    out.mkdir(parents=True, exist_ok=True)

    model, _ = load_encoder(opts.checkpoint_path, device=device)
    decoder = model.decoder
    if opts.clip_weights:
        clip_model = load_clip_weights(opts.clip_weights, device=device)
    else:
        clip_model = CLIP(device=device)
        print("WARNING: random CLIP (no --clip_weights)")
    tokenizer = SimpleTokenizer(opts.bpe_path or str(model_paths["clip_bpe_vocab"]))

    stats = Path(opts.stats_path)
    with open(stats / "s_stats", "rb") as f:
        _, s_mean, s_std = pickle.load(f)
    delta_i_c = np.load(stats / "delta_i_c.npy")
    gd = StyleCLIPGlobalDirection(delta_i_c, s_std, load_templates(opts.templates_path),
                                  {k: v[None] for k, v in s_mean.items()}, clip_model, tokenizer)

    latents = np.load(opts.latents_path, allow_pickle=True).item()
    names = sorted(latents)[:opts.n_images]
    ws = torch.as_tensor(np.stack([np.asarray(latents[n])[-1] for n in names]),
                         dtype=torch.float32, device=device)
    all_s = decoder.w2s(ws)
    for beta in opts.betas:
        delta_s = gd.get_delta_s(opts.neutral_text, opts.target_text, beta)
        for alpha in opts.alphas:
            imgs = decoder.synthesize(None, all_s=apply_delta_s(all_s, delta_s, alpha))
            for name, img in zip(names, imgs):
                tensor2im(img).save(out / f"{Path(name).stem}_a{alpha}_b{beta}.png")
            print(f"alpha={alpha} beta={beta}: {len(names)} edits saved")
    return out


def main(argv: Optional[Sequence[str]] = None) -> Path:
    return run(parse_dataclass(StyleCLIPEditOptions, argv))


if __name__ == "__main__":
    main()
