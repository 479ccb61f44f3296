"""StyleCLIP global-directions preprocessing (CLI): S statistics, then delta_i_c.

The port of the JAX package's `scripts/styleclip_preprocess.py` (reference
editing/styleclip_global_directions/preprocess/{s_statistics,
create_delta_i_c}.py), with its options plus ``--device``. ``--stage
stats`` writes ``s_stats`` (``[transform, s_mean, s_std]``) and ``S_1000``
as pickles; ``--stage delta_i_c`` reads them and writes ``delta_i_c.npy``,
a run of channels a generator call, as the JAX CLI does. The files are the
JAX package's (its StyleSpace key order).

The generator is a ``.npz`` from `convert_checkpoint` or a reference ``.pt``
state dict; without ``--generator_path`` it is seeded random. CLIP is an
OpenAI state dict saved with `torch.save` (``--clip_weights``), read with
``weights_only=True``; without it a seeded random ViT-B/32. It runs on the
CUDA card unless ``--device cpu``.

    python -m stylegan3_editing_tpu_torch.scripts.styleclip_preprocess \\
        --stage stats --generator_path G.npz --output_path STATS [--device cpu]
    python -m stylegan3_editing_tpu_torch.scripts.styleclip_preprocess \\
        --stage delta_i_c --generator_path G.npz --clip_weights clip.pt \\
        --output_path STATS
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..editing.styleclip_global import compute_delta_i_c, compute_s_statistics
from ..models.backbones.clip import CLIP, load_clip_weights
from ..models.sg3 import Generator, load_jax_variables, sg3_r_config, sg3_t_config
from ..models.sg3.convert import load_torch_pt, npz_to_variables
from ..utils.cli import parse_dataclass


@dataclasses.dataclass
class PreprocessOptions:
    stage: str = "stats"  # 'stats' | 'delta_i_c'
    output_path: str = "./styleclip_stats"
    generator_path: Optional[str] = None
    clip_weights: Optional[str] = None  # OpenAI CLIP state dict (.pt)
    stylegan_size: int = 1024
    is_landscape: bool = False
    truncation_psi: float = 0.5
    truncation_cutoff: int = 8
    num_images: int = 100_000
    num_samples: int = 1
    manipulation_strength: float = 5.0
    channels_per_batch: int = 8
    seed: int = 0
    decoder_channel_base: Optional[int] = None
    decoder_channel_max: Optional[int] = None
    decoder_num_layers: Optional[int] = None
    device: Optional[str] = None  # cuda unless "cpu"


def build_generator(opts: PreprocessOptions, device) -> Generator:
    overrides = {k: v for k, v in {
        "channel_base": opts.decoder_channel_base,
        "channel_max": opts.decoder_channel_max,
        "num_layers": opts.decoder_num_layers}.items() if v}
    cfg = (sg3_t_config if opts.is_landscape else sg3_r_config)(opts.stylegan_size, **overrides)
    G = Generator(cfg, device=device, generator=torch.Generator().manual_seed(opts.seed))
    if opts.generator_path and str(opts.generator_path).endswith(".npz"):
        load_jax_variables(G, npz_to_variables(opts.generator_path))
    elif opts.generator_path:
        load_jax_variables(G, load_torch_pt(opts.generator_path, cfg)[0])
    else:
        print("WARNING: random generator (no --generator_path)")
    return G


@torch.no_grad()
def run(opts: PreprocessOptions):
    device = resolve_device(opts.device)
    out = Path(opts.output_path)
    out.mkdir(parents=True, exist_ok=True)
    G = build_generator(opts, device)

    if opts.stage == "stats":
        transform, s_mean, s_std, s_1k = compute_s_statistics(
            G, num_images=opts.num_images, truncation_psi=opts.truncation_psi,
            truncation_cutoff=opts.truncation_cutoff, seed=opts.seed)
        with open(out / "s_stats", "wb") as f:
            pickle.dump([transform, s_mean, s_std], f)
        with open(out / "S_1000", "wb") as f:
            pickle.dump(s_1k, f)
        print(f"wrote s_stats + S_1000 → {out}")
        return transform, s_mean, s_std, s_1k

    if opts.stage != "delta_i_c":
        raise SystemExit(f"--stage must be 'stats' or 'delta_i_c', got {opts.stage!r}")
    if opts.clip_weights:
        clip_model = load_clip_weights(opts.clip_weights, device=device)
    else:
        clip_model = CLIP(device=device, generator=torch.Generator().manual_seed(1))
        print("WARNING: random CLIP (no --clip_weights)")
    with open(out / "s_stats", "rb") as f:
        _, s_mean, s_std = pickle.load(f)
    with open(out / "S_1000", "rb") as f:
        s_1k = pickle.load(f)
    delta = compute_delta_i_c(
        G, clip_model, s_1k, s_mean, s_std, num_samples=opts.num_samples,
        manipulation_strength=opts.manipulation_strength,
        channels_per_batch=opts.channels_per_batch)
    np.save(out / "delta_i_c.npy", delta)
    print(f"wrote delta_i_c {delta.shape} → {out / 'delta_i_c.npy'}")
    return delta


def main(argv: Optional[Sequence[str]] = None):
    return run(parse_dataclass(PreprocessOptions, argv))


if __name__ == "__main__":
    main()
