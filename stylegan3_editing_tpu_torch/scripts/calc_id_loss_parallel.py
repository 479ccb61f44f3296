"""ID similarity over inversion outputs with a CurricularFace IR-101 (CLI).

The port of the JAX package's `scripts/calc_id_loss_parallel.py` (reference
inversion/scripts/calc_id_loss_parallel.py), with its options plus
``--device``: each reconstruction under ``output_path`` (or under each of
its ``step_*`` folders) and its ground truth in ``gt_path`` are embedded by
IR-101 (`IRSEBackbone(112, 100, "ir", drop_ratio=0.4, affine=False)`), and
the mean and std of their cosine similarities go to ``id_scores.json``.

Faces are MTCNN-aligned 112² warps, as the reference's (`MTCNN.align`),
when the three released detector files exist; without them the JAX
package's protocol is the centre crop (rows 35:223, columns 32:220 of the
256² face, pooled to 112²), and the script says so: those similarities are
not comparable with published MTCNN-aligned numbers. The IR-101 weights are
a torch state dict read with ``torch.load(weights_only=True)``; without
them a seeded random IR-101, with a warning. The reference's process pool is
one batched embedding call; it runs on the CUDA card unless ``--device cpu``
(images are read with PIL on the host).

    python -m stylegan3_editing_tpu_torch.scripts.calc_id_loss_parallel \\
        --output_path OUT --gt_path GT --curricular_face_path CF.pth [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import model_paths
from ..data.transforms import compose, pil_to_array, resize
from ..device import resolve_device
from ..models.backbones.irse import IRSEBackbone, convert_irse_state
from ..models.mtcnn import MTCNN
from ..models.sg3 import load_jax_variables
from ..ops.image import adaptive_avg_pool2d
from ..utils.cli import parse_dataclass


@dataclasses.dataclass
class IDLossCalcOptions:
    output_path: str = "./inference_results"
    gt_path: str = "./gt_images"
    batch_size: int = 4
    curricular_face_path: Optional[str] = None  # torch state dict (.pth)
    # MTCNN .npy weight files; when all three exist, faces are detector-aligned.
    mtcnn_pnet: str = str(model_paths["mtcnn_pnet"])
    mtcnn_rnet: str = str(model_paths["mtcnn_rnet"])
    mtcnn_onet: str = str(model_paths["mtcnn_onet"])
    device: Optional[str] = None  # cuda unless "cpu"


def build_facenet(opts: IDLossCalcOptions, device) -> IRSEBackbone:
    """IR-101 from ``curricular_face_path``, or seeded random."""
    net = IRSEBackbone(input_size=112, num_layers=100, mode="ir", drop_ratio=0.4, affine=False,
                       generator=torch.Generator().manual_seed(0))
    if opts.curricular_face_path:
        state = {k: v.numpy() for k, v in torch.load(opts.curricular_face_path,
                                                     map_location="cpu",
                                                     weights_only=True).items()}
        load_jax_variables(net, convert_irse_state(state, num_layers=100, affine=False))
    else:
        print("WARNING: CurricularFace weights not provided; similarities use a randomly "
              "initialized IR-101")
    return net.to(device).eval()


def build_aligner(opts: IDLossCalcOptions, device) -> Optional[MTCNN]:
    paths = [opts.mtcnn_pnet, opts.mtcnn_rnet, opts.mtcnn_onet]
    if all(Path(p).exists() for p in paths):
        return MTCNN.from_npy(*paths, device=device)
    print("WARNING: MTCNN weights not found "
          f"({', '.join(str(p) for p in paths)}); falling back to the "
          "center-crop protocol — similarities are NOT comparable to "
          "reference-published MTCNN-aligned numbers")
    return None


def embed_center_crop(net: torch.nn.Module, imgs: torch.Tensor) -> torch.Tensor:
    """256² faces in [-1, 1] → embeddings of their 35:223, 32:220 crop at 112²."""
    return net(adaptive_avg_pool2d(imgs[:, 35:223, 32:220, :], 112))


@torch.no_grad()
def run(opts: IDLossCalcOptions) -> dict:
    from PIL import Image

    device = resolve_device(opts.device)
    net = build_facenet(opts, device)
    aligner = build_aligner(opts, device)
    prep = compose(resize(256), pil_to_array)
    embed = (lambda x: embed_center_crop(net, x)) if aligner is None else net

    def load_face(path: Path) -> Optional[np.ndarray]:
        """→ [112, 112, 3] in [-1, 1] (aligned) or [256, 256, 3] (crop)."""
        img = Image.open(path).convert("RGB")
        if aligner is None:
            return prep(img)
        face, _ = aligner.align(np.asarray(img))
        if face is None:
            return None
        # reference id_transform: ToTensor + Normalize(.5, .5) → [-1, 1]
        return np.asarray(face, np.float32) / 127.5 - 1.0

    out_root = Path(opts.output_path)
    step_dirs = sorted(out_root.glob("step_*")) or [out_root]
    results = {}
    for step_dir in step_dirs:
        sims = []
        names = sorted(p.name for p in step_dir.iterdir()
                       if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
        batch_a, batch_b = [], []

        def flush():
            if not batch_a:
                return
            ea, eb = (embed(torch.from_numpy(np.stack(b)).to(device)) for b in (batch_a, batch_b))
            sims.extend((ea * eb).sum(-1).cpu().numpy().tolist())
            batch_a.clear()
            batch_b.clear()

        for n in names:
            a = load_face(step_dir / n)
            b = load_face(Path(opts.gt_path) / n)
            if a is None or b is None:  # the reference skips undetected faces
                print(f"skipping {n} (no face detected)")
                continue
            batch_a.append(a)
            batch_b.append(b)
            if len(batch_a) == opts.batch_size:
                flush()
        flush()
        results[step_dir.name] = {"mean": float(np.mean(sims)), "std": float(np.std(sims)),
                                  "n": len(sims)}
        print(f"id_similarity {step_dir.name}: {results[step_dir.name]['mean']:.4f} "
              f"± {results[step_dir.name]['std']:.4f}")
    with open(out_root / "id_scores.json", "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(parse_dataclass(IDLossCalcOptions, argv))


if __name__ == "__main__":
    main()
