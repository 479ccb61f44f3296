"""MTCNN face detection and 5-point alignment (nets on the device, box
utilities and the similarity warp in numpy on the host).

Counterpart of the JAX package's `models/mtcnn.py` (reference
models/setgan/encoder/mtcnn/): the P/R/O-Nets (mtcnn/src/get_nets.py), the
box utilities (box_utils.py: nms, calibration, square conversion), the
staged detector (detector.py / first_stage.py) with `detect`, `align` and
`from_npy`, `convert_mtcnn_npy` for the released ``.npy`` weights, and the
similarity-transform and `warp_affine` helpers (align_trans.py,
matlab_cp2tform.py). The numpy parts are copies of the JAX package's. The
ID-similarity metric (`scripts/calc_id_loss_parallel.py`) aligns with it.

The nets follow the JAX package, which pools with ``padding=1`` on the R-
and O-Nets' first 3×3 pools and without ``ceil_mode`` everywhere; the
reference's ``MaxPool2d(ceil_mode=True)`` gives the same sizes at 24² and
48² with windows one pixel over, so released weights would score other
values through either package (ROADMAP Queue 3, facts of the reference).
Parameters carry the flax names (``conv1.kernel``, ``prelu1.alpha``,
``fc_probs.kernel``). The detector is built on the CUDA card unless
``device="cpu"`` is passed; the image pyramid and the crops are resized
with PIL on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.image import max_pool2d
from .backbones.common import Conv2d, Dense, PReLU
from .sg3.from_jax import load_jax_variables


def _flatten_chw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """Proposal net, fully convolutional: NHWC → (offsets, probs) maps."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1, self.prelu1 = Conv2d(3, 10, 3, generator=generator), PReLU(10)
        self.conv2, self.prelu2 = Conv2d(10, 16, 3, generator=generator), PReLU(16)
        self.conv3, self.prelu3 = Conv2d(16, 32, 3, generator=generator), PReLU(32)
        self.conv4_2 = Conv2d(32, 4, 1, generator=generator)
        self.conv4_1 = Conv2d(32, 2, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = max_pool2d(self.prelu1(self.conv1(x)), 2, 2)
        x = self.prelu2(self.conv2(x))
        x = self.prelu3(self.conv3(x))
        return self.conv4_2(x), torch.softmax(self.conv4_1(x), dim=-1)


class RNet(nn.Module):
    """Refinement net on 24×24 crops → (offsets ``[N, 4]``, probs ``[N, 2]``)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1, self.prelu1 = Conv2d(3, 28, 3, generator=generator), PReLU(28)
        self.conv2, self.prelu2 = Conv2d(28, 48, 3, generator=generator), PReLU(48)
        self.conv3, self.prelu3 = Conv2d(48, 64, 2, generator=generator), PReLU(64)
        self.fc, self.prelu4 = Dense(64 * 3 * 3, 128, generator=generator), PReLU(128)
        self.fc_offsets = Dense(128, 4, generator=generator)
        self.fc_probs = Dense(128, 2, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = max_pool2d(self.prelu1(self.conv1(x)), 3, 2, padding=1)
        x = max_pool2d(self.prelu2(self.conv2(x)), 3, 2)
        x = self.prelu3(self.conv3(x))
        x = self.prelu4(self.fc(_flatten_chw(x)))
        return self.fc_offsets(x), torch.softmax(self.fc_probs(x), dim=-1)


class ONet(nn.Module):
    """Output net on 48×48 crops → (landmarks ``[N, 10]``, offsets, probs)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1, self.prelu1 = Conv2d(3, 32, 3, generator=generator), PReLU(32)
        self.conv2, self.prelu2 = Conv2d(32, 64, 3, generator=generator), PReLU(64)
        self.conv3, self.prelu3 = Conv2d(64, 64, 3, generator=generator), PReLU(64)
        self.conv4, self.prelu4 = Conv2d(64, 128, 2, generator=generator), PReLU(128)
        self.fc, self.prelu5 = Dense(128 * 3 * 3, 256, generator=generator), PReLU(256)
        self.fc_landmarks = Dense(256, 10, generator=generator)
        self.fc_offsets = Dense(256, 4, generator=generator)
        self.fc_probs = Dense(256, 2, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = max_pool2d(self.prelu1(self.conv1(x)), 3, 2, padding=1)
        x = max_pool2d(self.prelu2(self.conv2(x)), 3, 2)
        x = max_pool2d(self.prelu3(self.conv3(x)), 2, 2)
        x = self.prelu4(self.conv4(x))
        x = self.prelu5(self.fc(_flatten_chw(x)))
        return (self.fc_landmarks(x), self.fc_offsets(x),
                torch.softmax(self.fc_probs(x), dim=-1))


# ------------------------------------------------------------- box utils

def nms(boxes: np.ndarray, overlap_threshold: float = 0.5,
        mode: str = "union") -> List[int]:
    """Greedy non-maximum suppression over [x1, y1, x2, y2, score] rows."""
    if len(boxes) == 0:
        return []
    x1, y1, x2, y2, score = boxes[:, 0], boxes[:, 1], boxes[:, 2], \
        boxes[:, 3], boxes[:, 4]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(score)
    keep = []
    while len(order):
        i = order[-1]
        keep.append(int(i))
        rest = order[:-1]
        ix1 = np.maximum(x1[i], x1[rest])
        iy1 = np.maximum(y1[i], y1[rest])
        ix2 = np.minimum(x2[i], x2[rest])
        iy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, ix2 - ix1 + 1)
        h = np.maximum(0.0, iy2 - iy1 + 1)
        inter = w * h
        if mode == "min":
            overlap = inter / np.minimum(area[i], area[rest])
        else:
            overlap = inter / (area[i] + area[rest] - inter)
        order = rest[overlap <= overlap_threshold]
    return keep


def calibrate_box(boxes: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Apply regression offsets to boxes."""
    x1, y1, x2, y2 = (boxes[:, i] for i in range(4))
    w = (x2 - x1 + 1)[:, None]
    h = (y2 - y1 + 1)[:, None]
    translation = np.hstack([w, h, w, h]) * offsets
    out = boxes.copy()
    out[:, :4] = boxes[:, :4] + translation
    return out


def convert_to_square(boxes: np.ndarray) -> np.ndarray:
    """Expand boxes to squares around their centers."""
    out = boxes.copy()
    x1, y1, x2, y2 = (boxes[:, i] for i in range(4))
    h = y2 - y1 + 1
    w = x2 - x1 + 1
    side = np.maximum(h, w)
    out[:, 0] = x1 + w * 0.5 - side * 0.5
    out[:, 1] = y1 + h * 0.5 - side * 0.5
    out[:, 2] = out[:, 0] + side - 1
    out[:, 3] = out[:, 1] + side - 1
    return out


def generate_bboxes(probs: np.ndarray, offsets: np.ndarray, scale: float,
                    threshold: float) -> np.ndarray:
    """PNet output maps → candidate boxes at the original image scale."""
    stride, cell = 2, 12
    face_probs = probs[0, :, :, 1]
    ys, xs = np.where(face_probs > threshold)
    if len(ys) == 0:
        return np.zeros((0, 9))
    off = offsets[0, ys, xs, :]
    score = face_probs[ys, xs]
    boxes = np.vstack([
        np.round((stride * xs + 1.0) / scale),
        np.round((stride * ys + 1.0) / scale),
        np.round((stride * xs + 1.0 + cell) / scale),
        np.round((stride * ys + 1.0 + cell) / scale),
        score,
    ]).T
    return np.hstack([boxes, off])


def convert_mtcnn_npy(pnet_path, rnet_path, onet_path):
    """Convert the released MTCNN .npy weight dicts to variable trees in the
    flax layout (HWIO conv kernels, ``[in, out]`` dense kernels), which
    `load_jax_variables` copies into `PNet`, `RNet` and `ONet`.

    Parity: reference mtcnn_pytorch/src/get_nets.py:61-63 loads dicts keyed
    by torch parameter names (features.convN.weight OIHW, preluN, and the
    conv4_1/conv5_1/conv6_* heads). The reference's Flatten transposes
    NCHW→NCWH before flattening (get_nets.py:29), so its Linear columns are
    (c, w, h)-ordered; our flatten is (c, h, w) — dense columns permute.
    Returns (pnet_vars, rnet_vars, onet_vars).
    """

    def conv(d, name):
        return {"kernel": np.transpose(d[f"{name}.weight"], (2, 3, 1, 0)),
                "bias": d[f"{name}.bias"]}

    def prelu(d, name):
        return {"alpha": d[f"{name}.weight"]}

    def dense(d, name, cin=None, spatial=None):
        w = np.asarray(d[f"{name}.weight"])
        if spatial is not None:  # first dense after flatten: (c,w,h)→(c,h,w)
            w = w.reshape(w.shape[0], cin, spatial, spatial)
            w = np.transpose(w, (0, 1, 3, 2)).reshape(w.shape[0], -1)
        return {"kernel": w.T, "bias": d[f"{name}.bias"]}

    def load(path):
        return np.load(path, allow_pickle=True)[()]

    p = load(pnet_path)
    pnet_vars = {"params": {
        "conv1": conv(p, "features.conv1"),
        "prelu1": prelu(p, "features.prelu1"),
        "conv2": conv(p, "features.conv2"),
        "prelu2": prelu(p, "features.prelu2"),
        "conv3": conv(p, "features.conv3"),
        "prelu3": prelu(p, "features.prelu3"),
        "conv4_1": conv(p, "conv4_1"),
        "conv4_2": conv(p, "conv4_2"),
    }}
    r = load(rnet_path)
    rnet_vars = {"params": {
        "conv1": conv(r, "features.conv1"),
        "prelu1": prelu(r, "features.prelu1"),
        "conv2": conv(r, "features.conv2"),
        "prelu2": prelu(r, "features.prelu2"),
        "conv3": conv(r, "features.conv3"),
        "prelu3": prelu(r, "features.prelu3"),
        "fc": dense(r, "features.conv4", cin=64, spatial=3),
        "prelu4": prelu(r, "features.prelu4"),
        "fc_probs": dense(r, "conv5_1"),
        "fc_offsets": dense(r, "conv5_2"),
    }}
    o = load(onet_path)
    onet_vars = {"params": {
        "conv1": conv(o, "features.conv1"),
        "prelu1": prelu(o, "features.prelu1"),
        "conv2": conv(o, "features.conv2"),
        "prelu2": prelu(o, "features.prelu2"),
        "conv3": conv(o, "features.conv3"),
        "prelu3": prelu(o, "features.prelu3"),
        "conv4": conv(o, "features.conv4"),
        "prelu4": prelu(o, "features.prelu4"),
        "fc": dense(o, "features.conv5", cin=128, spatial=3),
        "prelu5": prelu(o, "features.prelu5"),
        "fc_probs": dense(o, "conv6_1"),
        "fc_offsets": dense(o, "conv6_2"),
        "fc_landmarks": dense(o, "conv6_3"),
    }}
    as_f32 = lambda t: {c: {k: {n: np.asarray(a, np.float32) for n, a in leaves.items()}
                            for k, leaves in mods.items()} for c, mods in t.items()}
    return as_f32(pnet_vars), as_f32(rnet_vars), as_f32(onet_vars)


class MTCNN:
    """Staged detector over converted P/R/O-Net variables."""

    @classmethod
    def from_npy(cls, pnet_path, rnet_path, onet_path, device: DeviceLike = None) -> "MTCNN":
        """Build from the released .npy weight files (`configs.model_paths`
        mtcnn_pnet/rnet/onet)."""
        return cls(*convert_mtcnn_npy(pnet_path, rnet_path, onet_path), device=device)

    def __init__(self, pnet_vars=None, rnet_vars=None, onet_vars=None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        """Each net from its variable tree (flax layout), or seeded random."""
        self.device = resolve_device(device)
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        self.pnet, self.rnet, self.onet = (PNet(generator), RNet(generator), ONet(generator))
        for net, variables in ((self.pnet, pnet_vars), (self.rnet, rnet_vars),
                               (self.onet, onet_vars)):
            if variables is not None:
                load_jax_variables(net, variables)
            net.to(self.device).eval()

    def _run(self, net: nn.Module, x: np.ndarray):
        """A net on a host batch → its outputs as host arrays."""
        with torch.no_grad():
            out = net(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device))
        return tuple(o.cpu().numpy() for o in out)

    @staticmethod
    def _preprocess(img: np.ndarray) -> np.ndarray:
        return (np.asarray(img, np.float32) - 127.5) * 0.0078125

    @staticmethod
    def _valid_boxes(boxes: np.ndarray) -> np.ndarray:
        """Drop degenerate (inverted) boxes that extreme regression
        offsets can produce — zero-area crops would crash resizing."""
        return boxes[(boxes[:, 2] >= boxes[:, 0])
                     & (boxes[:, 3] >= boxes[:, 1])]

    def _crop_boxes(self, img: np.ndarray, boxes: np.ndarray,
                    size: int) -> np.ndarray:
        from PIL import Image

        crops = []
        h, w = img.shape[:2]
        for box in convert_to_square(boxes):
            x1, y1, x2, y2 = [int(v) for v in box[:4]]
            x1c, y1c = max(x1, 0), max(y1, 0)
            x2c, y2c = min(x2, w - 1), min(y2, h - 1)
            patch = np.zeros((y2 - y1 + 1, x2 - x1 + 1, 3), np.uint8)
            if x2c >= x1c and y2c >= y1c:
                patch[y1c - y1:y2c - y1 + 1, x1c - x1:x2c - x1 + 1] = \
                    img[y1c:y2c + 1, x1c:x2c + 1]
            crop = np.asarray(Image.fromarray(patch).resize((size, size),
                                                            Image.BILINEAR))
            crops.append(self._preprocess(crop))
        return np.stack(crops)

    def detect(self, img: np.ndarray,
               min_face_size: float = 20.0,
               thresholds=(0.6, 0.7, 0.8),
               nms_thresholds=(0.7, 0.7, 0.7)
               ) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 HWC image → (boxes [K, 5], landmarks [K, 10])."""
        from PIL import Image

        h, w = img.shape[:2]
        min_length = min(h, w)
        min_detection_size = 12
        factor = 0.707
        scales = []
        m = min_detection_size / min_face_size
        min_length *= m
        power = 0
        while min_length > min_detection_size:
            scales.append(m * factor ** power)
            min_length *= factor
            power += 1

        # Stage 1: PNet over the image pyramid.
        all_boxes = []
        for scale in scales:
            sw, sh = int(np.ceil(w * scale)), int(np.ceil(h * scale))
            scaled = np.asarray(Image.fromarray(img).resize(
                (sw, sh), Image.BILINEAR))
            offsets, probs = self._run(self.pnet, self._preprocess(scaled)[None])
            boxes = generate_bboxes(probs, offsets, scale, thresholds[0])
            if len(boxes):
                boxes = boxes[nms(boxes[:, :5], 0.5)]
                all_boxes.append(boxes)
        if not all_boxes:
            return np.zeros((0, 5)), np.zeros((0, 10))
        boxes = np.vstack(all_boxes)
        boxes = boxes[nms(boxes[:, :5], nms_thresholds[0])]
        boxes = self._valid_boxes(calibrate_box(boxes[:, :5], boxes[:, 5:]))
        if len(boxes) == 0:
            return np.zeros((0, 5)), np.zeros((0, 10))

        # Stage 2: RNet.
        crops = self._crop_boxes(img, boxes, 24)
        offsets, probs = self._run(self.rnet, crops)
        keep = np.where(probs[:, 1] > thresholds[1])[0]
        boxes = boxes[keep]
        boxes[:, 4] = probs[keep, 1]
        offsets = offsets[keep]
        if len(boxes) == 0:
            return np.zeros((0, 5)), np.zeros((0, 10))
        keep = nms(boxes, nms_thresholds[1])
        boxes = self._valid_boxes(calibrate_box(boxes[keep], offsets[keep]))
        if len(boxes) == 0:
            return np.zeros((0, 5)), np.zeros((0, 10))

        # Stage 3: ONet + landmarks.
        crops = self._crop_boxes(img, boxes, 48)
        landmarks, offsets, probs = self._run(self.onet, crops)
        keep = np.where(probs[:, 1] > thresholds[2])[0]
        boxes = boxes[keep]
        boxes[:, 4] = probs[keep, 1]
        offsets, landmarks = offsets[keep], landmarks[keep]
        if len(boxes) == 0:
            return np.zeros((0, 5)), np.zeros((0, 10))
        # Landmarks to absolute coordinates.
        wbox = boxes[:, 2] - boxes[:, 0] + 1
        hbox = boxes[:, 3] - boxes[:, 1] + 1
        lm = landmarks.copy()
        lm[:, :5] = boxes[:, 0:1] + wbox[:, None] * landmarks[:, :5]
        lm[:, 5:] = boxes[:, 1:2] + hbox[:, None] * landmarks[:, 5:]
        boxes = calibrate_box(boxes, offsets)
        keep = nms(boxes, nms_thresholds[2], mode="min")
        return boxes[keep], lm[keep]

    # -------------------------------------------- 5-point alignment API

    def align(self, img: np.ndarray,
              thresholds=(0.15, 0.25, 0.35)
              ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Detect + similarity-warp the first face to a 112×112 crop.

        Parity: reference models/setgan/encoder/mtcnn/mtcnn.py:24-30 —
        including that fork's lowered detection thresholds (:46-48).
        Returns (uint8 HWC 112×112 face, 2×3 transform) or (None, None)
        when no face is found.
        """
        img = np.asarray(img)
        _, landmarks = self.detect(img, thresholds=thresholds)
        if len(landmarks) == 0:
            return None, None
        pts = np.stack([landmarks[0][:5], landmarks[0][5:]], axis=1)
        return warp_and_crop_face(img, pts,
                                  get_reference_facial_points(
                                      default_square=True),
                                  crop_size=(112, 112))

    def align_multi(self, img: np.ndarray, limit: Optional[int] = None,
                    min_face_size: float = 30.0,
                    thresholds=(0.15, 0.25, 0.35)):
        """All-faces variant → (boxes, [112² faces], [2×3 transforms]).

        Parity: reference mtcnn.py:32-44.
        """
        img = np.asarray(img)
        boxes, landmarks = self.detect(img, min_face_size=min_face_size,
                                       thresholds=thresholds)
        if limit:
            boxes, landmarks = boxes[:limit], landmarks[:limit]
        ref = get_reference_facial_points(default_square=True)
        faces, tfms = [], []
        for lm in landmarks:
            pts = np.stack([lm[:5], lm[5:]], axis=1)
            face, tfm = warp_and_crop_face(img, pts, ref,
                                           crop_size=(112, 112))
            faces.append(face)
            tfms.append(tfm)
        return boxes, faces, tfms


# ------------------------------------------- 5-point similarity alignment
#
# Host-side numpy port of the reference's MTCNN face-alignment math:
# models/setgan/encoder/mtcnn/mtcnn_pytorch/src/align_trans.py (reference
# facial points + warp_and_crop_face) and matlab_cp2tform.py (the MATLAB
# cp2tform similarity solve). These feed the ID-similarity metric protocol
# (reference inversion/scripts/calc_id_loss_parallel.py:115), so the math
# must match the reference numerically — including its reflective-branch
# selection semantics (see find_similarity).

# Canonical ArcFace 5-point template for a (96, 112) crop
# (align_trans.py:15-21) — an interface constant shared by every framework
# that consumes these 112² face crops.
REFERENCE_FACIAL_POINTS = np.array([
    [30.29459953, 51.69630051],
    [65.53179932, 51.50139999],
    [48.02519989, 71.73660278],
    [33.54930115, 92.3655014],
    [62.72990036, 92.20410156],
], dtype=np.float64)

DEFAULT_CROP_SIZE = (96, 112)  # (w, h)


def get_reference_facial_points(output_size=None,
                                inner_padding_factor: float = 0.0,
                                outer_padding=(0, 0),
                                default_square: bool = False) -> np.ndarray:
    """Reference 5-point template for a given crop geometry.

    Parity: align_trans.py:32-160. `default_square=True` pads the (96, 112)
    template symmetrically to (112, 112) — the geometry every consumer in
    the reference uses (mtcnn.py:22).
    """
    pts = REFERENCE_FACIAL_POINTS.copy()
    crop = np.array(DEFAULT_CROP_SIZE, dtype=np.float64)
    if default_square:
        diff = crop.max() - crop
        pts += diff / 2
        crop += diff
    if output_size is not None and tuple(output_size) == tuple(crop):
        return pts
    if inner_padding_factor == 0 and tuple(outer_padding) == (0, 0):
        if output_size is None:
            return pts
        raise ValueError(
            f"no paddings requested: output_size must be None or "
            f"{tuple(crop)}, got {tuple(output_size)}")
    if not 0 <= inner_padding_factor <= 1.0:
        raise ValueError("inner_padding_factor must be in [0, 1]")
    if output_size is None:
        output_size = np.round(
            crop * (1 + inner_padding_factor * 2)).astype(np.int64)
        output_size = output_size + np.array(outer_padding)
    if not (outer_padding[0] < output_size[0]
            and outer_padding[1] < output_size[1]):
        raise ValueError("outer_padding must be smaller than output_size")
    if inner_padding_factor > 0:
        diff = crop * inner_padding_factor * 2
        pts += diff / 2
        crop += np.round(diff)
    inner = np.array(output_size, dtype=np.float64) \
        - np.array(outer_padding, dtype=np.float64) * 2
    if inner[0] * crop[1] != inner[1] * crop[0]:
        raise ValueError(
            "output_size - outer_padding must preserve the padded "
            "template's aspect ratio")
    pts = pts * (inner[0] / crop[0])
    return pts + np.array(outer_padding, dtype=np.float64)


def tform_fwd(trans: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Apply a 3×3 row-vector affine: [x y 1] = [u v 1] @ trans."""
    uv1 = np.hstack([uv, np.ones((uv.shape[0], 1))])
    return (uv1 @ trans)[:, :2]


def find_nonreflective_similarity(uv: np.ndarray, xy: np.ndarray
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares 4-dof similarity (scale·rot + translation), uv → xy.

    Parity: matlab_cp2tform.py:68-116 (MATLAB cp2tform
    'nonreflective similarity'). Returns (T, Tinv), both 3×3 row-vector
    matrices with T[:, 2] == [0, 0, 1].
    """
    uv = np.asarray(uv, dtype=np.float64)
    xy = np.asarray(xy, dtype=np.float64)
    m = xy.shape[0]
    x = xy[:, :1]
    y = xy[:, 1:2]
    ones = np.ones((m, 1))
    zeros = np.zeros((m, 1))
    # Unknowns r = [sc, ss, tx, ty] solve  X r = U  where each landmark
    # contributes the two rows [x  y 1 0] -> u and [y -x 0 1] -> v.
    X = np.vstack([np.hstack([x, y, ones, zeros]),
                   np.hstack([y, -x, zeros, ones])])
    U = np.vstack([uv[:, :1], uv[:, 1:2]])
    if np.linalg.matrix_rank(X) < 4:
        raise ValueError("cp2tform: at least 2 unique point pairs required")
    r = np.linalg.lstsq(X, U, rcond=None)[0].ravel()
    sc, ss, tx, ty = r
    tinv = np.array([[sc, -ss, 0.0],
                     [ss, sc, 0.0],
                     [tx, ty, 1.0]])
    t = np.linalg.inv(tinv)
    t[:, 2] = [0.0, 0.0, 1.0]
    return t, tinv


def find_similarity(uv: np.ndarray, xy: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Reflective similarity solve, uv → xy.

    Parity: matlab_cp2tform.py:119-156 — including the reference's exact
    branch-selection semantics: its `xyR = xy; xyR[:, 0] *= -1` mutates
    `xy` IN PLACE, so both candidate transforms are scored against the
    REFLECTED targets. The two scores then differ only by each fit's
    residual, which still deterministically picks a branch; reproducing it
    keeps warp outputs bit-comparable with reference-published metrics.
    """
    uv = np.asarray(uv, dtype=np.float64)
    xy = np.asarray(xy, dtype=np.float64).copy()
    trans1, trans1_inv = find_nonreflective_similarity(uv, xy)
    xy_r = xy  # alias, mutated below — intentional (see docstring)
    xy_r[:, 0] = -xy_r[:, 0]
    trans2r, _ = find_nonreflective_similarity(uv, xy_r)
    reflect_y = np.array([[-1.0, 0.0, 0.0],
                          [0.0, 1.0, 0.0],
                          [0.0, 0.0, 1.0]])
    trans2 = trans2r @ reflect_y
    norm1 = np.linalg.norm(tform_fwd(trans1, uv) - xy_r)
    norm2 = np.linalg.norm(tform_fwd(trans2, uv) - xy_r)
    if norm1 <= norm2:
        return trans1, trans1_inv
    return trans2, np.linalg.inv(trans2)


def get_similarity_transform(src_pts: np.ndarray, dst_pts: np.ndarray,
                             reflective: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(trans, trans_inv) 3×3 row-vector matrices mapping src → dst.

    Parity: matlab_cp2tform.py:159-196.
    """
    if reflective:
        return find_similarity(src_pts, dst_pts)
    return find_nonreflective_similarity(src_pts, dst_pts)


def get_similarity_transform_cv2(src_pts: np.ndarray, dst_pts: np.ndarray,
                                 reflective: bool = True) -> np.ndarray:
    """2×3 column-vector matrix for warp_affine ([x y]ᵀ = M [u v 1]ᵀ).

    Parity: matlab_cp2tform.py:199-261 (get_similarity_transform_for_cv2).
    """
    trans, _ = get_similarity_transform(src_pts, dst_pts, reflective)
    return trans[:, :2].T


def warp_affine(img: np.ndarray, tfm: np.ndarray,
                out_size: Tuple[int, int]) -> np.ndarray:
    """Bilinear affine warp matching cv2.warpAffine(img, tfm, (w, h)).

    `tfm` is a forward 2×3 matrix (dst = tfm @ [src, 1]); sampling inverts
    it per output pixel with zero padding outside the source. Uses cv2 when
    importable (exact protocol match incl. its fixed-point rounding); the
    numpy fallback is float bilinear (≤1 uint8 LSB apart).
    """
    w, h = int(out_size[0]), int(out_size[1])
    try:
        import cv2

        return cv2.warpAffine(img, np.asarray(tfm, np.float64), (w, h))
    except ImportError:
        pass
    a = np.asarray(tfm, dtype=np.float64)
    full = np.vstack([a, [0.0, 0.0, 1.0]])
    inv = np.linalg.inv(full)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    src = np.asarray(img, dtype=np.float64)
    if src.ndim == 2:
        src = src[:, :, None]
    sh, sw = src.shape[:2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]

    def tap(yi, xi):
        valid = ((xi >= 0) & (xi < sw) & (yi >= 0) & (yi < sh))[..., None]
        return np.where(valid,
                        src[np.clip(yi, 0, sh - 1), np.clip(xi, 0, sw - 1)],
                        0.0)

    out = (tap(y0, x0) * (1 - fx) * (1 - fy)
           + tap(y0, x0 + 1) * fx * (1 - fy)
           + tap(y0 + 1, x0) * (1 - fx) * fy
           + tap(y0 + 1, x0 + 1) * fx * fy)
    if np.issubdtype(np.asarray(img).dtype, np.integer):
        out = np.round(out).clip(0, 255).astype(np.uint8)
    if np.asarray(img).ndim == 2:
        out = out[:, :, 0]
    return out


def warp_and_crop_face(src_img: np.ndarray, facial_pts,
                       reference_pts=None,
                       crop_size: Tuple[int, int] = (96, 112),
                       align_type: str = "similarity"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Similarity-warp a face to the reference template → (crop, 2×3 tfm).

    Parity: align_trans.py:210-304 (warp_and_crop_face). `align_type` ∈
    {'similarity', 'affine'}; the reference's 'cv2_affine' 3-point variant
    is subsumed by 'affine' over the first 3 points.
    """
    if reference_pts is None:
        if tuple(crop_size) == DEFAULT_CROP_SIZE:
            reference_pts = REFERENCE_FACIAL_POINTS
        else:
            reference_pts = get_reference_facial_points(
                output_size=crop_size, default_square=False)
    ref = np.asarray(reference_pts, dtype=np.float64)
    if ref.shape[0] == 2 and ref.shape[1] > 2:
        ref = ref.T
    src = np.asarray(facial_pts, dtype=np.float64)
    if src.shape[0] == 2 and src.shape[1] > 2:
        src = src.T
    if src.shape != ref.shape:
        raise ValueError(
            f"facial_pts {src.shape} and reference_pts {ref.shape} must "
            f"have the same (K, 2) shape with K > 2")
    if align_type == "affine":
        ones = np.ones((src.shape[0], 1))
        A = np.linalg.lstsq(np.hstack([src, ones]),
                            np.hstack([ref, ones]), rcond=None)[0]
        tfm = A[:, :2].T
    else:
        tfm = get_similarity_transform_cv2(src, ref)
    face = warp_affine(src_img, tfm, crop_size)
    return face, tfm
