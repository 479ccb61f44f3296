"""FFHQ face alignment math and the landmark → generator-transform bridge.

A copy of the JAX package's `utils/alignment_utils.py` (reference
utils/alignment_utils.py): the alignment quad from eye and mouth landmarks,
the fixed cropping quad, shrink/crop/pad/blur-pad and the QUAD warp, and
`get_stylegan_transform_from_landmarks`, which turns the eyes of an
(unaligned, aligned) pair into the 3×3 transform the generator's input
takes (its ``transform`` argument).

The dlib 68-landmark detector is pluggable: every geometric function takes
landmark arrays, so the math runs without dlib. Host-side only: PIL and
`scipy.ndimage` are imported where an image is cropped or warped, dlib in
`get_dlib_detector` and `get_landmark` (the card machine has none of them).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from .common import make_transform


def get_dlib_detector(shape_predictor_path: str):
    """(detector, predictor) via dlib — raises with guidance if absent."""
    try:
        import dlib
    except ImportError as e:
        raise ImportError(
            "dlib is not installed in this environment; pass precomputed "
            "landmarks to the alignment functions instead") from e
    return dlib.get_frontal_face_detector(), dlib.shape_predictor(
        str(shape_predictor_path))


def dlib_landmark_fn(shape_predictor_path: str) -> Callable[[Image.Image], np.ndarray]:
    """``fn(image) -> [68, 2]``: the landmarks of the last face dlib finds in
    a PIL image (the landmark function of the video CLIs)."""
    detector, predictor = get_dlib_detector(shape_predictor_path)

    def fn(img: Image.Image) -> np.ndarray:
        arr = np.asarray(img.convert("RGB"))
        shape = None
        for det in detector(arr, 1):
            shape = predictor(arr, det)
        assert shape is not None, "no face found"
        return np.array([[p.x, p.y] for p in shape.parts()])

    return fn


def get_landmark(filepath: str, detector, predictor) -> np.ndarray:
    """68-point landmarks of the (last detected) face in an image file."""
    import dlib  # noqa: F401  (only reachable when dlib exists)
    from PIL import Image

    img = np.asarray(Image.open(filepath).convert("RGB"))
    shape = None
    for det in detector(img, 1):
        shape = predictor(img, det)
    assert shape is not None, f"no face found in {filepath}"
    return np.array([[p.x, p.y] for p in shape.parts()])


def get_eyes_coors(landmark: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return landmark[36:42].mean(axis=0), landmark[42:48].mean(axis=0)


def get_rotation_from_eyes(left_eye_unaligned, right_eye_unaligned,
                           left_eye_aligned, right_eye_aligned) -> float:
    """Rotation (degrees) aligning the eye axis of two crops."""
    v1 = right_eye_unaligned - left_eye_unaligned
    v2 = right_eye_aligned - left_eye_aligned
    v1 = v1 / np.linalg.norm(v1)
    v2 = v2 / np.linalg.norm(v2)
    r = np.degrees(np.arccos(np.clip(np.inner(v1, v2), -1.0, 1.0)))
    if right_eye_unaligned[1] > left_eye_unaligned[1]:
        r = 360 - r
    return float(r)


def get_alignment_positions_from_landmarks(
        lm: np.ndarray, eyes_distance_only: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FFHQ oriented-crop basis (center c, x-axis, y-axis) from landmarks."""
    eye_left, eye_right = get_eyes_coors(lm)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x = x / np.hypot(*x)
    if eyes_distance_only:
        x = x * (np.hypot(*eye_to_eye) * 2.0)
    else:
        x = x * max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    return c, x, y


def get_alignment_transformation(c, x, y) -> Tuple[np.ndarray, float]:
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    return quad, float(np.hypot(*x) * 2)


def get_fixed_cropping_transformation(c, x) -> Tuple[np.ndarray, float]:
    """Axis-aligned crop quad with the same scale (used for video crops)."""
    d = np.hypot(x[0], x[1])
    dh, dv = np.array([d, 0.0]), np.array([0.0, d])
    quad = np.stack([c - dh - dv, c - dh + dv, c + dh + dv, c + dh - dv])
    return quad, float(np.hypot(*x) * 2)


def crop_face_by_transform(img: Image.Image, quad: np.ndarray, qsize: float,
                           output_size: int = 1024, transform_size: int = 1024,
                           enable_padding: bool = True) -> Image.Image:
    """Shrink → crop → reflect-pad+blur → QUAD-warp an image to a face crop."""
    import scipy.ndimage
    from PIL import Image

    quad = quad.copy()

    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (int(np.rint(img.size[0] / shrink)),
                 int(np.rint(img.size[1] / shrink)))
        img = img.resize(rsize, Image.LANCZOS)
        quad /= shrink
        qsize /= shrink

    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
            int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, img.size[0]),
            min(crop[3] + border, img.size[1]))
    if crop[2] - crop[0] < img.size[0] or crop[3] - crop[1] < img.size[1]:
        img = img.crop(crop)
        quad -= crop[0:2]

    pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
           int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - img.size[0] + border, 0),
           max(pad[3] - img.size[1] + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(np.float32(img),
                     ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), "reflect")
        h, w, _ = arr.shape
        yy, xx = np.ogrid[:h, :w]
        mask = np.maximum(
            1.0 - np.minimum(xx / max(pad[0], 1), (w - 1 - xx) / max(pad[2], 1)),
            1.0 - np.minimum(yy / max(pad[1], 1), (h - 1 - yy) / max(pad[3], 1)),
        )[:, :, None].astype(np.float32)
        blur = qsize * 0.02
        arr += (scipy.ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr) \
            * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = Image.fromarray(np.uint8(np.clip(np.rint(arr), 0, 255)), "RGB")
        quad += pad[:2]

    img = img.transform((transform_size, transform_size), Image.QUAD,
                        (quad + 0.5).flatten(), Image.BILINEAR)
    if output_size < transform_size:
        img = img.resize((output_size, output_size), Image.LANCZOS)
    return img


def align_face_from_landmarks(img: Image.Image, lm: np.ndarray,
                              output_size: int = 1024) -> Image.Image:
    c, x, y = get_alignment_positions_from_landmarks(lm)
    quad, qsize = get_alignment_transformation(c, x, y)
    return crop_face_by_transform(img, quad, qsize, output_size, output_size)


def crop_face_from_landmarks(img: Image.Image, lm: np.ndarray,
                             random_shift: float = 0.0,
                             output_size: int = 1024,
                             rng: Optional[np.random.RandomState] = None
                             ) -> Image.Image:
    c, x, y = get_alignment_positions_from_landmarks(lm)
    if random_shift > 0:
        rng = rng or np.random
        c = c + np.hypot(*x) * 2 * random_shift * rng.normal(0, 1, c.shape)
    quad, qsize = get_fixed_cropping_transformation(c, x)
    return crop_face_by_transform(img, quad, qsize, output_size, output_size)


def get_stylegan_transform_from_landmarks(
        lm_unaligned: np.ndarray, lm_aligned: np.ndarray,
        aligned_image: Image.Image,
        landmark_fn: Optional[Callable[[Image.Image], np.ndarray]] = None,
) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray]:
    """(rotation, translation, transform, inverse) between a cropped frame
    and its aligned counterpart — the bridge into the generator's user
    transform. `landmark_fn` re-detects landmarks on the rotated aligned
    image (falls back to rotating the aligned landmarks analytically)."""
    ua_left, ua_right = get_eyes_coors(lm_unaligned)
    al_left, al_right = get_eyes_coors(lm_aligned)
    rotation_angle = get_rotation_from_eyes(ua_left, ua_right, al_left, al_right)

    rotated = aligned_image.rotate(rotation_angle)
    if landmark_fn is not None:
        rot_lm = landmark_fn(rotated)
        rot_left, _ = get_eyes_coors(rot_lm)
    else:
        # Analytic rotation of the aligned eye coordinate about image center.
        w, h = aligned_image.size
        center = np.array([w / 2, h / 2])
        theta = np.radians(rotation_angle)
        rot = np.array([[np.cos(theta), np.sin(theta)],
                        [-np.sin(theta), np.cos(theta)]])
        rot_left = (al_left - center) @ rot.T + center

    translation = (np.asarray(ua_left) - rot_left) / aligned_image.size[0]
    transform = make_transform(tuple(translation), rotation_angle)
    return rotation_angle, translation, transform, np.linalg.inv(transform)
