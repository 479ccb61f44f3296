"""Video inversion and editing, end to end (CLI).

The port of the JAX package's `scripts/inference_on_video.py` (reference
inversion/video/inference_on_video.py), with its options (`VideoConfig`)
plus ``--device``: frames → align and crop → landmark transforms → ReStyle
per batch of frames with the landmarks transforms (fp32 decode unless
``--bf16_decode``) → smoothed FOV-expanded renders → InterFaceGAN edits of
every frame at both ends of each range → mp4s (PNG frames without an
ffmpeg backend). The landmarks come from dlib's 68-point predictor
(`configs.model_paths["shape_predictor"]`). Reading and aligning frames
needs cv2 and Pillow, writing videos imageio; the inversion, smoothing and
edits run on the CUDA card unless ``--device cpu``.

    python -m stylegan3_editing_tpu_torch.scripts.inference_on_video \\
        --video_path clip.mp4 --checkpoint_path CKPT --output_path OUT \\
        [--interfacegan_directions age --interfacegan_ranges "(-4_5)"] [--device cpu]
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import model_paths
from ..data.transforms import compose, pil_to_array, resize
from ..device import resolve_device
from ..models.encoders import get_average_image, run_restyle_iterations
from ..utils import alignment_utils as au
from ..utils.cli import parse_dataclass
from ..utils.common import generate_mp4
from ..utils.inference_utils import load_encoder
from ..video.post_processing import postprocess_and_smooth_inversions, smooth_ws
from ..video.video_config import VideoConfig
from ..video.video_editor import InterFaceGANVideoEditor
from ..video.video_handler import LandmarksHandler, VideoHandler


@torch.inference_mode()
def run_inference_on_video(opts: VideoConfig):
    from PIL import Image

    device = resolve_device(opts.device)
    out = Path(opts.output_path)
    out.mkdir(parents=True, exist_ok=True)

    landmark_fn = au.dlib_landmark_fn(model_paths["shape_predictor"])
    handler = VideoHandler(opts.video_path, out, landmark_fn, max_frames=opts.max_frames)
    frames, aligned, cropped = handler.parse_video()

    lm = LandmarksHandler(out, opts.landmarks_transforms_path, landmark_fn=landmark_fn)
    transforms = lm.get_landmarks_transforms(frames, handler.cropped_frames_path,
                                             handler.aligned_frames_path)

    model, _ = load_encoder(opts.checkpoint_path, device=device)
    avg_image, latent_avg = get_average_image(model)
    res = model.decoder_cfg.img_resolution

    prep = compose(resize(256), pil_to_array)
    names = [p.name for p in aligned if p.name in transforms]
    result_latents, frame_transforms = {}, []
    for start in range(0, len(names), opts.batch_size):
        batch_names = names[start:start + opts.batch_size]
        x = torch.as_tensor(np.stack(
            [prep(Image.open(handler.aligned_frames_path / n)) for n in batch_names]),
            device=device)
        lmt = torch.as_tensor(np.stack(
            [np.asarray(transforms[n][-1], np.float32) for n in batch_names]), device=device)
        results = run_restyle_iterations(model, x, avg_image, latent_avg,
                                         n_iters=opts.n_iters_per_batch,
                                         landmarks_transform=lmt,
                                         force_fp32=not opts.bf16_decode)
        final_codes = results[-1][2].cpu().numpy()
        for bi, n in enumerate(batch_names):
            result_latents[n] = final_codes[bi]
            frame_transforms.append(np.asarray(transforms[n][-1], np.float32))

    decoder = model.decoder
    smoothed = postprocess_and_smooth_inversions(
        result_latents, frame_transforms, decoder, res, expansion_amounts=opts.expansion_amounts)

    inputs = [Image.open(handler.cropped_frames_path / n) for n in names]
    generate_mp4(out / "input_video", [np.asarray(im) for im in inputs], {"fps": opts.fps})
    generate_mp4(out / "result_video_smoothed", smoothed, {"fps": opts.fps})

    # Optional InterFaceGAN edits.
    if opts.interfacegan_directions:
        directions = {}
        for name in opts.interfacegan_directions:
            path = Path(model_paths["interfacegan_boundaries"]) / f"{name}_boundary.npy"
            directions[name] = np.load(path)
        editor = InterFaceGANVideoEditor(decoder, res, out, directions, opts.expansion_amounts)
        latents_arr = np.stack(list(result_latents.values()))
        smoothed_t = smooth_ws(np.stack(frame_transforms))
        for edit in opts.interfacegan_edits():
            _, _, lat_start, lat_end = editor.edit(edit.direction, edit.start, edit.end,
                                                   latents_arr, frame_transforms)
            for tag, lat in (("start", lat_start), ("end", lat_end)):
                frames_e = editor.postprocess_and_smooth_edits(lat, smoothed_t)
                editor.generate_edited_video(inputs, smoothed, frames_e, opts.fps,
                                             f"edited_video_{edit.direction}_{tag}")
    print(f"video pipeline done: {len(names)} frames on {device} → {out}")
    return result_latents, smoothed


def main(argv: Optional[Sequence[str]] = None):
    return run_inference_on_video(parse_dataclass(VideoConfig, argv))


if __name__ == "__main__":
    main()
