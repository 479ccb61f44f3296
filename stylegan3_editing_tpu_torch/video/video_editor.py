"""Video editing: per-frame InterFaceGAN and StyleCLIP edits, smoothed renders.

Counterpart of the JAX package's `video/video_editor.py` (reference
inversion/video/video_editor.py): `InterFaceGANVideoEditor` edits every
frame at both ends of a factor range, `StyleCLIPVideoEditor` applies a
text-driven StyleSpace delta to every frame; both smooth the edited
latents and transforms, render through the FOV `Expander`, and write mp4s.
Each edit is one batched synthesis over all frames, as in the JAX package.
The renders need no Pillow; `generate_edited_video` (it resizes the input
frames with PIL) and the mp4 writer (imageio) do.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..editing.interfacegan import FaceEditor
from ..editing.styleclip_global import StyleCLIPGlobalDirection, apply_delta_s
from ..utils.common import generate_mp4
from .post_processing import average_fine_layers, render_smoothed, smooth_ws


class VideoEditor:
    def __init__(self, generator, resolution: int, output_path,
                 expansion_amounts=(0, 0, 0, 0)):
        self.generator = generator
        self.resolution = resolution
        self.output_path = Path(output_path)
        self.expansion_amounts = expansion_amounts

    def get_smoothed_edited_images(self, edit_latents: np.ndarray,
                                   smoothed_transforms: np.ndarray) -> List[np.ndarray]:
        return render_smoothed(self.generator, self.resolution, smooth_ws(edit_latents),
                               smoothed_transforms, self.expansion_amounts)

    def generate_edited_video(self, input_images: Sequence,
                              result_images_smoothed: List[np.ndarray],
                              edited_images_smoothed: List[np.ndarray],
                              fps: float, save_name: str) -> None:
        kwargs = {"fps": fps}
        generate_mp4(self.output_path / save_name, edited_images_smoothed, kwargs)
        coupled = []
        for im, smooth_im, edit_im in zip(list(input_images)[2:-2], result_images_smoothed,
                                          edited_images_smoothed):
            h = smooth_im.shape[0]
            im_r = np.array(im.resize((h, h))) if hasattr(im, "resize") else im
            coupled.append(np.concatenate([im_r, smooth_im, edit_im], axis=1))
        generate_mp4(self.output_path / f"{save_name}_coupled", coupled, kwargs)


class InterFaceGANVideoEditor(VideoEditor):
    def __init__(self, generator, resolution, output_path,
                 directions: Dict[str, np.ndarray], expansion_amounts=(0, 0, 0, 0)):
        super().__init__(generator, resolution, output_path, expansion_amounts)
        self.latent_editor = FaceEditor(generator, directions=directions)

    @torch.no_grad()
    def edit(self, edit_direction: str, start: float, end: float,
             result_latents: np.ndarray,
             landmarks_transforms: Optional[Sequence[np.ndarray]] = None):
        """Edit all frames at both ends of the range, each one synthesis over
        the frames → (images at start, at end, latents at start, at end)."""
        device = next(self.generator.parameters()).device
        latents = torch.as_tensor(np.asarray(result_latents), device=device)  # [T, num_ws, 512]
        t = (np.stack(landmarks_transforms).astype(np.float32)
             if landmarks_transforms is not None else None)
        outs = {}
        for tag, factor in (("start", start), ("end", end)):
            images, edit_latents = self.latent_editor.edit(
                latents, edit_direction, factor=factor, user_transforms=t,
                apply_user_transformations=t is not None)
            outs[tag] = (images, edit_latents.cpu().numpy())
        latents_dir = self.output_path / "latents"
        latents_dir.mkdir(parents=True, exist_ok=True)
        np.save(latents_dir / f"latents_{edit_direction}_start.npy", outs["start"][1])
        np.save(latents_dir / f"latents_{edit_direction}_end.npy", outs["end"][1])
        return outs["start"][0], outs["end"][0], outs["start"][1], outs["end"][1]

    def postprocess_and_smooth_edits(self, edit_latents: np.ndarray,
                                     smoothed_transforms: np.ndarray) -> List[np.ndarray]:
        edit_latents = average_fine_layers(np.asarray(edit_latents))
        return self.get_smoothed_edited_images(edit_latents, smoothed_transforms)


class StyleCLIPVideoEditor(VideoEditor):
    def __init__(self, generator, resolution, output_path,
                 direction_calculator: StyleCLIPGlobalDirection, expansion_amounts=(0, 0, 0, 0)):
        super().__init__(generator, resolution, output_path, expansion_amounts)
        self.gd = direction_calculator

    @torch.no_grad()
    def edit(self, target_text: str, alpha: float, beta: float, result_latents: np.ndarray,
             neutral_text: str = "face",
             landmarks_transforms: Optional[Sequence[np.ndarray]] = None):
        """Text-driven StyleSpace edit of all frames in one synthesis →
        (images, edited StyleSpace)."""
        device = next(self.generator.parameters()).device
        delta_s = self.gd.get_delta_s(neutral_text, target_text, beta)
        ws = torch.as_tensor(np.asarray(result_latents), device=device)
        edited_s = apply_delta_s(self.generator.w2s(ws), delta_s, alpha)
        if landmarks_transforms is not None:
            t = torch.as_tensor(np.stack(landmarks_transforms).astype(np.float32), device=device)
        else:
            t = torch.eye(3, device=device).expand(ws.shape[0], 3, 3)
        images = self.generator.synthesize(None, all_s=edited_s, transform=t)
        return images, edited_s
