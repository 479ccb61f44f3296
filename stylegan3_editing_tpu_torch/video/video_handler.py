"""Video decode and per-frame face alignment and fixed cropping (host-side).

A copy of the JAX package's `video/video_handler.py` (reference
inversion/video/video_handler.py): cv2 frame extraction, per-frame
alignment, a fixed crop from the first frame's alignment quad, and the
landmark transforms' cache. Landmark detection is pluggable (dlib or any
function of a PIL image). cv2 is imported in `extract_frames` and PIL
where a frame is read, so the module imports on a machine with neither.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from ..utils import alignment_utils as au


class VideoHandler:
    """Parses a video into raw / aligned / cropped frame folders."""

    def __init__(self, video_path, output_path,
                 landmark_fn: Optional[Callable] = None,
                 max_frames: Optional[int] = None, output_size: int = 1024):
        """`landmark_fn(image: PIL) -> [68, 2]` landmarks (dlib or other)."""
        self.video_path = str(video_path)
        self.output_path = Path(output_path)
        self.landmark_fn = landmark_fn
        self.max_frames = max_frames
        self.output_size = output_size
        self.raw_frames_path = self.output_path / "raw_frames"
        self.aligned_frames_path = self.output_path / "aligned_frames"
        self.cropped_frames_path = self.output_path / "cropped_frames"

    def extract_frames(self) -> List[Path]:
        """Decode the video to PNG frames (cv2)."""
        import cv2

        self.raw_frames_path.mkdir(parents=True, exist_ok=True)
        cap = cv2.VideoCapture(self.video_path)
        paths = []
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok or (self.max_frames and idx >= self.max_frames):
                break
            path = self.raw_frames_path / f"{idx:04d}.png"
            cv2.imwrite(str(path), frame)
            paths.append(path)
            idx += 1
        cap.release()
        return paths

    def align_frames(self, frame_paths: List[Path]) -> List[Path]:
        """FFHQ-align every frame (per-frame landmarks)."""
        from PIL import Image

        assert self.landmark_fn is not None, "landmark_fn required to align"
        self.aligned_frames_path.mkdir(parents=True, exist_ok=True)
        out = []
        for path in frame_paths:
            img = Image.open(path).convert("RGB")
            lm = self.landmark_fn(img)
            aligned = au.align_face_from_landmarks(img, lm, self.output_size)
            dst = self.aligned_frames_path / path.name
            aligned.save(dst)
            out.append(dst)
        return out

    def crop_frames(self, frame_paths: List[Path]) -> List[Path]:
        """Fixed crop of all frames using the FIRST frame's alignment quad
        (keeps the camera static across the video, video_handler.py:81-96)."""
        from PIL import Image

        assert self.landmark_fn is not None, "landmark_fn required to crop"
        self.cropped_frames_path.mkdir(parents=True, exist_ok=True)
        first = Image.open(frame_paths[0]).convert("RGB")
        lm = self.landmark_fn(first)
        c, x, _ = au.get_alignment_positions_from_landmarks(lm)
        quad, qsize = au.get_fixed_cropping_transformation(c, x)
        out = []
        for path in frame_paths:
            img = Image.open(path).convert("RGB")
            cropped = au.crop_face_by_transform(img, quad, qsize,
                                                self.output_size,
                                                self.output_size)
            dst = self.cropped_frames_path / path.name
            cropped.save(dst)
            out.append(dst)
        return out

    def parse_video(self):
        frames = self.extract_frames()
        aligned = self.align_frames(frames)
        cropped = self.crop_frames(frames)
        return frames, aligned, cropped


class LandmarksHandler:
    """Compute & cache name → (angle, translation, transform, inverse).

    Parity: prepare_data/landmarks_handler.py:12-54.
    """

    def __init__(self, output_path, landmarks_transforms_path=None,
                 landmark_fn: Optional[Callable] = None):
        if landmarks_transforms_path is None:
            landmarks_transforms_path = Path(output_path) / "landmarks_transforms.npy"
        self.path = Path(landmarks_transforms_path)
        self.landmark_fn = landmark_fn

    def get_landmarks_transforms(self, input_paths, cropped_frames_path,
                                 aligned_frames_path,
                                 force_computing: bool = False) -> dict:
        if self.path.exists() and not force_computing:
            return np.load(str(self.path), allow_pickle=True).item()
        from PIL import Image

        assert self.landmark_fn is not None, "landmark_fn required"
        transforms = {}
        for path in input_paths:
            cropped = Path(cropped_frames_path) / path.name
            aligned = Path(aligned_frames_path) / path.name
            try:
                img_c = Image.open(cropped).convert("RGB")
                img_a = Image.open(aligned).convert("RGB")
                lm_c = self.landmark_fn(img_c)
                lm_a = self.landmark_fn(img_a)
                transforms[path.name] = au.get_stylegan_transform_from_landmarks(
                    lm_c, lm_a, img_a, landmark_fn=self.landmark_fn)
            except Exception as e:  # skip frames the detector fails on
                print(f"failed on {cropped}: {e}")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        np.save(str(self.path), transforms)
        return transforms
