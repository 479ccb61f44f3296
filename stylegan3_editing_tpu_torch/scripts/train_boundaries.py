"""Train an InterFaceGAN linear boundary from latents and attribute scores (CLI).

The port of the JAX package's `scripts/train_boundaries.py` (reference
editing/interfacegan/{train_boundaries,generate_latents_and_attribute_scores}.py),
with its options plus ``--device``: sample z → W in chunks of 256 (numpy's
`RandomState(seed)`, truncation ψ), optionally pseudo-align (w0 = w_avg),
render and score the images with one scorer (`score_latents`), then fit a
linear SVM on w0 (`train_boundary`, scikit-learn on the host) and save
``<attribute>_boundary.npy``.

The attribute is a CelebA name (`AttributeClassifier`), ``age``
(`AgeEstimator`) or ``pose_yaw`` / ``pose_pitch`` / ``pose_roll``
(`PoseEstimator`). The scorers' released weights are not read yet: they are
random from a seeded `torch.Generator`, as the JAX CLI's are from its init.
The generator is a ``.npz`` from `convert_checkpoint` or a reference ``.pt``
state dict; without ``--generator_path`` it is seeded random. It runs on the
CUDA card unless ``--device cpu``. `sample_ws`, `scorer_for` and
`score_ws` are the steps up to the scores, which run where scikit-learn is
absent.

    python -m stylegan3_editing_tpu_torch.scripts.train_boundaries \\
        --generator_path G.npz --attribute Smiling --output_dir OUT [--device cpu]
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..editing.attribute_scorers import (CELEBA_ATTRIBUTES, AgeEstimator, AttributeClassifier,
                                         PoseEstimator, score_latents)
from ..editing.interfacegan import pseudo_align_latents, train_boundary
from ..models.sg3 import Generator, load_jax_variables, sg3_r_config
from ..models.sg3.convert import load_torch_pt, npz_to_variables
from ..utils.cli import parse_dataclass

SAMPLE_CHUNK = 256


@dataclasses.dataclass
class BoundaryOptions:
    output_dir: str = "./boundaries"
    generator_path: Optional[str] = None
    output_size: int = 1024
    n_samples: int = 10000
    batch_size: int = 8
    truncation_psi: float = 0.7
    attribute: str = "Smiling"  # CelebA name, or 'age', or 'pose_yaw'
    pseudo_align: bool = False
    seed: int = 0
    decoder_channel_base: Optional[int] = None
    decoder_channel_max: Optional[int] = None
    decoder_num_layers: Optional[int] = None
    device: Optional[str] = None  # cuda unless "cpu"


def build_generator(opts: BoundaryOptions, device) -> Generator:
    overrides = {k: v for k, v in {
        "channel_base": opts.decoder_channel_base,
        "channel_max": opts.decoder_channel_max,
        "num_layers": opts.decoder_num_layers}.items() if v}
    cfg = sg3_r_config(opts.output_size, **overrides)
    G = Generator(cfg, device=device, generator=torch.Generator().manual_seed(opts.seed))
    if opts.generator_path and str(opts.generator_path).endswith(".npz"):
        load_jax_variables(G, npz_to_variables(opts.generator_path))
    elif opts.generator_path:
        load_jax_variables(G, load_torch_pt(opts.generator_path, cfg)[0])
    else:
        print("WARNING: random generator (no --generator_path)")
    return G


@torch.no_grad()
def sample_ws(G: Generator, opts: BoundaryOptions) -> torch.Tensor:
    """``n_samples`` W+ latents on G's device: z from ``RandomState(seed)``
    in chunks of 256, mapped at ``truncation_psi``; w0 set to w_avg with
    ``pseudo_align``."""
    rng = np.random.RandomState(opts.seed)
    device = G.mapping.w_avg.device
    chunks = []
    for start in range(0, opts.n_samples, SAMPLE_CHUNK):
        n = min(SAMPLE_CHUNK, opts.n_samples - start)
        z = torch.from_numpy(rng.randn(n, G.cfg.z_dim).astype(np.float32)).to(device)
        chunks.append(G.map(z, truncation_psi=opts.truncation_psi))
    ws = torch.cat(chunks)
    return pseudo_align_latents(ws, G.mapping.w_avg) if opts.pseudo_align else ws


def scorer_for(attribute: str, device) -> Tuple[torch.nn.Module, Callable]:
    """(scorer, select): the network that scores ``attribute`` (random
    weights from seed 1, as the JAX CLI's init key) and the function that
    picks the attribute's score from its output."""
    gen = torch.Generator().manual_seed(1)
    if attribute == "age":
        return AgeEstimator(device=device, generator=gen).eval(), lambda out: out
    if attribute.startswith("pose_"):
        axis = attribute.split("_", 1)[1]
        return PoseEstimator(device=device, generator=gen).eval(), lambda out: out[axis]
    idx = CELEBA_ATTRIBUTES.index(attribute)
    return (AttributeClassifier(device=device, generator=gen).eval(),
            lambda out: out[:, idx])


def score_ws(G: Generator, scorer: torch.nn.Module, select: Callable, ws: torch.Tensor,
             batch_size: int) -> np.ndarray:
    """``[N, 1]`` scores of the renders of ``ws`` (the generator's own
    precision policy), ``batch_size`` a render."""
    return score_latents(lambda w, t: G.synthesize(w), lambda imgs: select(scorer(imgs)), ws,
                         batch_size=batch_size)


def run(opts: BoundaryOptions) -> np.ndarray:
    device = resolve_device(opts.device)
    G = build_generator(opts, device)
    ws = sample_ws(G, opts)
    scores = score_ws(G, *scorer_for(opts.attribute, device), ws, opts.batch_size)
    # Boundary on w0 (the reference trains on W, one row per sample).
    boundary = train_boundary(ws[:, 0, :].cpu().numpy(), scores, chosen_num_or_ratio=0.02)
    out = Path(opts.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / f"{opts.attribute}_boundary.npy", boundary)
    print(f"saved boundary → {out / f'{opts.attribute}_boundary.npy'}")
    return boundary


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    return run(parse_dataclass(BoundaryOptions, argv))


if __name__ == "__main__":
    main()
