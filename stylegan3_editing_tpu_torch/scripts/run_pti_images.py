"""Pivotal tuning over inverted latents (CLI), per image or one generator for all.

The port of the JAX package's `scripts/run_pti_images.py` (reference
inversion/scripts/run_pti_images.py and, with ``--shared_weights``,
inversion/video/run_pti_video.py), with its options plus ``--device``. It
starts from a ReStyle ``latents.npy`` (name → ``[n_iters, n_styles, 512]``,
the last iteration is the pivot) and a folder of images, tunes the
generator (LPIPS + L2, Adam, LPIPS early stop: a converged image is frozen,
not dropped, as in the JAX package) and writes what the JAX CLI writes:
``images/<name>``, and ``<stem>_model.npz`` per image (or
``pti_video_model.npz`` in shared mode) holding ``{"synthesis_tuned": ...}``
under the JAX package's flax key paths.

The generator is a ``.npz`` from `convert_checkpoint` or a reference ``.pt``
state dict; convert a ``.pkl`` first. Without ``--generator_path`` a seeded
random generator is tuned. It runs on the CUDA card unless ``--device cpu``.

    python -m stylegan3_editing_tpu_torch.scripts.run_pti_images \\
        --images_path DIR --latents_path latents.npy --generator_path G.npz \\
        --exp_dir OUT [--shared_weights true] [--device cpu]

`tune` is the part between reading and writing files: tensors in, renders
and per-image trees out (no Pillow needed).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..inversion.pti import PTI, PTIOptions
from ..models.sg3 import Generator, SG3Config, load_jax_variables, sg3_r_config
from ..models.sg3.convert import load_torch_pt, npz_to_variables, variables_to_npz
from ..utils.cli import parse_dataclass


@dataclasses.dataclass
class RunPTIOptions:
    exp_dir: str = "./experiments/pti"
    images_path: str = "./data"
    latents_path: str = "./latents.npy"
    generator_path: Optional[str] = None
    landmarks_transforms_path: Optional[str] = None
    output_size: int = 1024
    learning_rate: float = 3e-4
    lpips_lambda: float = 1.0
    l2_lambda: float = 1.0
    steps: int = 350
    lpips_threshold: float = 0.06
    batch_size: int = 4
    save_models: bool = True
    # Video PTI (reference inversion/video/run_pti_video.py:96-171): ONE
    # generator tuned over ALL inputs (frames) instead of per-image copies.
    shared_weights: bool = False
    # decoder capacity overrides (smoke tests / small domains)
    decoder_channel_base: Optional[int] = None
    decoder_channel_max: Optional[int] = None
    decoder_num_layers: Optional[int] = None
    device: Optional[str] = None  # cuda unless "cpu"


def decoder_config(opts: RunPTIOptions) -> SG3Config:
    overrides = {}
    if opts.decoder_channel_base:
        overrides["channel_base"] = opts.decoder_channel_base
    if opts.decoder_channel_max:
        overrides["channel_max"] = opts.decoder_channel_max
    if opts.decoder_num_layers:
        overrides["num_layers"] = opts.decoder_num_layers
    return sg3_r_config(opts.output_size, **overrides)


def load_generator(path: Optional[str], cfg: SG3Config, device: DeviceLike = None) -> Generator:
    """A `Generator` filled from a ``.npz`` (`npz_to_variables`) or a
    reference ``.pt``; seeded random weights when ``path`` is None."""
    if str(path).endswith(".pkl"):
        raise SystemExit(f"{path}: convert the pickle first (python -m "
                         "stylegan3_editing_tpu_torch.scripts.convert_checkpoint --src "
                         f"{path} --dst NAME) and pass NAME.npz")
    G = Generator(cfg, device=device, generator=torch.Generator().manual_seed(0))
    if path is None:
        print("WARNING: tuning a randomly initialized generator (no --generator_path)")
    elif str(path).endswith(".npz"):
        load_jax_variables(G, npz_to_variables(path))
    else:
        load_jax_variables(G, load_torch_pt(path, cfg)[0])
    return G


def nest(params: Dict[str, torch.Tensor], index: Optional[int] = None) -> dict:
    """Dotted parameter names (``L0_36_1024.affine.weight``) → the nested
    numpy tree of the flax paths; ``index`` picks one image of stacked
    parameters."""
    tree: dict = {}
    for name, value in params.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = (value if index is None else value[index]).detach().float().cpu().numpy()
    return tree


def tuned_variables(variables: dict, tuned: dict) -> dict:
    """A generator's variables with a ``synthesis_tuned`` tree installed
    (the JAX package's ``PTI.tuned_variables``)."""
    params = dict(variables["params"])
    params["synthesis"] = {**params["synthesis"], **tuned}
    return {**variables, "params": params}


def save_tuned(tree: dict, path) -> None:
    """The CLI's model file: ``{"synthesis_tuned": tree}`` as a flat ``.npz``."""
    variables_to_npz({"synthesis_tuned": tree}, path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tune(pti: PTI, codes: torch.Tensor, targets: torch.Tensor,
         transforms: Optional[torch.Tensor] = None, batch_size: int = 4,
         shared: bool = False, steps: Optional[int] = None
         ) -> Tuple[torch.Tensor, List[dict], List[dict]]:
    """Tune in batches of ``batch_size`` and render.

    codes ``[N, num_ws, 512]``, targets ``[N, H, W, 3]`` in [-1, 1],
    transforms ``[N, 3, 3]`` or None, on any device (each batch moves to
    the generator's). Returns (renders ``[N, H, W, 3]`` on the generator's
    device, trees, log): per image, each image's ``synthesis_tuned`` tree and
    one log entry per batch (seconds, lpips, converged); in shared mode, one
    tree and one log entry per step.
    """
    device = next(pti.G.parameters()).device
    n = codes.shape[0]

    def rows(start: int):
        sl = slice(start, start + batch_size)
        return (codes[sl].to(device), targets[sl].to(device),
                None if transforms is None else transforms[sl].to(device))

    if shared:
        params, history = pti.optimize_shared(
            lambda: (rows(s) for s in range(0, n, batch_size)), steps=steps)
        # As the JAX CLI: the renders take no transform and follow the
        # generator's own precision policy.
        with torch.no_grad():
            images = torch.cat([
                torch.func.functional_call(pti.G.synthesis, {**pti.frozen, **params},
                                           (rows(s)[0],))
                for s in range(0, n, batch_size)])
        return images, [nest(params)], history

    images, trees, log = [], [], []
    for start in range(0, n, batch_size):
        c, t, tf = rows(start)
        tic = time.perf_counter()
        stacked, imgs, metrics = pti.optimize_batch(c, t, tf, steps=steps)
        _sync(device)
        log.append({"start": start, "seconds": time.perf_counter() - tic,
                    "lpips": metrics["lpips"].tolist(),
                    "converged": metrics["converged"].tolist()})
        images.append(imgs)
        trees += [nest(stacked, i) for i in range(c.shape[0])]
    return torch.cat(images), trees, log


def _read_inputs(opts: RunPTIOptions, resolution: int):
    """(names, codes, targets, transforms or None) on the CPU."""
    from ..data import ImagesDataset, encode_transforms

    latents = np.load(opts.latents_path, allow_pickle=True).item()
    stored = None
    if opts.landmarks_transforms_path:
        stored = np.load(opts.landmarks_transforms_path, allow_pickle=True).item()
    t = encode_transforms(resolution=resolution)["transform_inference"]
    dataset = ImagesDataset(opts.images_path, opts.images_path, target_transform=t)
    index = {p.name: i for i, p in enumerate(dataset.source_paths) if p.name in latents}
    names = list(index)
    codes = torch.from_numpy(np.stack([np.asarray(latents[n])[-1] for n in names])).float()
    targets = torch.from_numpy(np.stack([dataset[index[n]][1] for n in names]))
    transforms = None
    if stored is not None:
        transforms = torch.from_numpy(np.stack([
            np.asarray(stored[n][-1] if isinstance(stored[n], (tuple, list)) else stored[n])
            for n in names])).float()
    return names, codes, targets, transforms


def run(opts: RunPTIOptions):
    from ..utils.common import tensor2im

    device = resolve_device(opts.device)
    out_dir = Path(opts.exp_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    cfg = decoder_config(opts)
    names, codes, targets, transforms = _read_inputs(opts, cfg.img_resolution)
    G = load_generator(opts.generator_path, cfg, device)
    pti = PTI(G, opts=PTIOptions(learning_rate=opts.learning_rate,
                                 lpips_lambda=opts.lpips_lambda, l2_lambda=opts.l2_lambda,
                                 steps=opts.steps, lpips_threshold=opts.lpips_threshold))

    tic = time.perf_counter()
    images, trees, log = tune(pti, codes, targets, transforms, opts.batch_size,
                              shared=opts.shared_weights)
    _sync(device)
    for name, img in zip(names, images):
        tensor2im(img).save(out_dir / "images" / name)
    if opts.shared_weights:
        print(f"shared-weights PTI over {len(names)} frames: {time.perf_counter() - tic:.1f}s, "
              f"final loss {log[-1]['loss']:.4f} (lpips {log[-1]['lpips']:.4f})")
        if opts.save_models:
            save_tuned(trees[0], out_dir / "pti_video_model.npz")
        return images, trees, log
    for entry in log:
        batch = names[entry["start"]:entry["start"] + opts.batch_size]
        print(f"batch {batch}: {entry['seconds']:.1f}s, "
              f"lpips={np.round(entry['lpips'], 4).tolist()}, converged={entry['converged']}")
    if opts.save_models:
        for name, tree in zip(names, trees):
            save_tuned(tree, out_dir / f"{Path(name).stem}_model.npz")
    return images, trees, log


def main(argv: Optional[Sequence[str]] = None):
    return run(parse_dataclass(RunPTIOptions, argv))


if __name__ == "__main__":
    main()
