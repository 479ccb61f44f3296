"""Parity of the port's MTCNN with the JAX package's, on the CPU: the P/R/O-Nets,
the box utilities, the similarity transforms and warps, `detect` and
`align` on a synthetic image, and `convert_mtcnn_npy` on ``.npy`` files the
test writes in the released files' layout.

The nets' weights are seeded trees shaped by the JAX init
(`test_torch_encoders.init_module`), or the converted ``.npy`` files, the
same in both packages.

Tolerances: the nets' outputs within 1e-5 of max |ref| (small fp32 convs
and dense layers summing in another order); the box utilities, the
similarity transforms, the warps and the converted trees exactly (the same
numpy code in both packages); `detect`'s boxes and landmarks within 1e-3
pixels (coordinates from probabilities and offsets that differ by ~1e-7),
the aligned 112² face within one uint8 level.
"""

import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stylegan3_editing_tpu.models import mtcnn as jmtcnn
from stylegan3_editing_tpu_torch.models import mtcnn
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from test_torch_encoders import check, init_module, seeded, t
from test_torch_video import frame

torch.set_num_threads(1)

NET_TOL = 1e-5
BOX_ATOL = 1e-3
NETS = {"pnet": (jmtcnn.PNet, mtcnn.PNet, (1, 61, 75, 3)),
        "rnet": (jmtcnn.RNet, mtcnn.RNet, (6, 24, 24, 3)),
        "onet": (jmtcnn.ONet, mtcnn.ONet, (6, 48, 48, 3))}


def _net_variables(name, seed):
    jcls, _, shape = NETS[name]
    return init_module(jcls(), np.zeros((1,) + shape[1:], np.float32), seed=seed)


def _tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# ----------------------------------------------------------------------- nets

@pytest.mark.parametrize("name", sorted(NETS))
def test_nets_match_jax(name):
    jcls, tcls, shape = NETS[name]
    v = _net_variables(name, seed=1)
    net = tcls()
    load_jax_variables(net, v)
    x = seeded(*shape, seed=2)
    ref = jcls().apply(v, x)
    with torch.no_grad():
        got = net(t(x))
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        check(a, b, NET_TOL, f"{name} output {i}")


def test_jax_pools_are_not_the_references_ceil_mode_pools():
    """A fact of the JAX package, which the port follows: its R- and O-Nets
    pool 3×3 / 2 with ``padding=1`` and its P-Net 2×2 / 2 without
    ``ceil_mode``, where the reference's nets (get_nets.py) use
    ``MaxPool2d(..., ceil_mode=True)``. On the R-Net's 22² map the sizes
    agree and the values do not (the windows start one pixel over); on the
    P-Net's odd maps the reference keeps one more row and column."""
    x = torch.from_numpy(seeded(1, 3, 22, 22, seed=3))
    ours = F.max_pool2d(x, 3, 2, padding=1)
    ref = F.max_pool2d(x, 3, 2, ceil_mode=True)
    assert ours.shape == ref.shape == (1, 3, 11, 11)
    assert not torch.equal(ours, ref)
    odd = torch.from_numpy(seeded(1, 3, 57, 57, seed=4))
    assert F.max_pool2d(odd, 2, 2).shape[-1] == 28
    assert F.max_pool2d(odd, 2, 2, ceil_mode=True).shape[-1] == 29


# ------------------------------------------------------------------ box utils

def _boxes(n, seed):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    return np.hstack([xy, xy + wh, rng.uniform(0, 1, (n, 1))])


@pytest.mark.parametrize("mode", ["union", "min"])
def test_nms_matches_jax(mode):
    boxes = _boxes(40, 5)
    for thr in (0.3, 0.5, 0.7):
        assert mtcnn.nms(boxes, thr, mode) == jmtcnn.nms(boxes, thr, mode)
    assert mtcnn.nms(np.zeros((0, 5))) == []


def test_box_utilities_match_jax():
    boxes = _boxes(12, 6)
    offsets = seeded(12, 4, seed=7) * 0.1
    np.testing.assert_array_equal(mtcnn.calibrate_box(boxes, offsets),
                                  jmtcnn.calibrate_box(boxes, offsets))
    np.testing.assert_array_equal(mtcnn.convert_to_square(boxes),
                                  jmtcnn.convert_to_square(boxes))
    probs = np.random.RandomState(8).uniform(0, 1, (1, 9, 11, 2))
    offs = seeded(1, 9, 11, 4, seed=9)
    for thr in (0.5, 0.9, 1.1):
        np.testing.assert_array_equal(mtcnn.generate_bboxes(probs, offs, 0.35, thr),
                                      jmtcnn.generate_bboxes(probs, offs, 0.35, thr))


# ----------------------------------------------------------- similarity warps

def _landmarks(seed):
    ref = mtcnn.get_reference_facial_points(default_square=True)
    rng = np.random.RandomState(seed)
    angle = rng.uniform(-0.4, 0.4)
    rot = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    return (ref - 56) @ rot.T * rng.uniform(1.5, 2.5) + rng.uniform(60, 100, 2) \
        + rng.normal(0, 1, ref.shape)


@pytest.mark.parametrize("kw", [dict(default_square=True), dict(),
                                dict(output_size=(123, 142), inner_padding_factor=0.1,
                                     outer_padding=(4, 4))],
                         ids=["square", "default", "padded"])
def test_reference_points_match_jax(kw):
    np.testing.assert_array_equal(mtcnn.get_reference_facial_points(**kw),
                                  jmtcnn.get_reference_facial_points(**kw))


@pytest.mark.parametrize("reflective", [True, False])
def test_similarity_transforms_match_jax(reflective):
    src, dst = _landmarks(10), mtcnn.get_reference_facial_points(default_square=True)
    for a, b in zip(mtcnn.get_similarity_transform(src, dst, reflective),
                    jmtcnn.get_similarity_transform(src, dst, reflective)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mtcnn.get_similarity_transform_cv2(src, dst, reflective),
                                  jmtcnn.get_similarity_transform_cv2(src, dst, reflective))


@pytest.mark.parametrize("cv2_present", [True, False], ids=["cv2", "numpy"])
@pytest.mark.parametrize("align_type", ["similarity", "affine"])
def test_warp_and_crop_face_matches_jax(cv2_present, align_type, monkeypatch):
    """Both warps: cv2's where it is installed, the numpy bilinear one where
    it is not (the card's machine)."""
    if not cv2_present:
        monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.asarray(frame(11, (180, 160)))
    pts = _landmarks(12)
    ref_pts = mtcnn.get_reference_facial_points(default_square=True)
    got = mtcnn.warp_and_crop_face(img, pts, ref_pts, (112, 112), align_type)
    ref = jmtcnn.warp_and_crop_face(img, pts, ref_pts, (112, 112), align_type)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (112, 112, 3) and got[0].dtype == np.uint8


# ------------------------------------------------------------------- detector

def _release_files(root, seed):
    """Three ``.npy`` weight dicts in the released files' naming (torch OIHW
    convs, ``[out, in]`` linears, PReLU weights)."""
    rng = np.random.RandomState(seed)

    def conv(d, name, o, i, k):
        d[f"{name}.weight"] = (rng.randn(o, i, k, k) / np.sqrt(i * k * k)).astype(np.float32)
        d[f"{name}.bias"] = (0.1 * rng.randn(o)).astype(np.float32)

    def linear(d, name, o, i):
        d[f"{name}.weight"] = (rng.randn(o, i) / np.sqrt(i)).astype(np.float32)
        d[f"{name}.bias"] = (0.1 * rng.randn(o)).astype(np.float32)

    def prelu(d, name, c):
        d[f"{name}.weight"] = (0.25 + 0.05 * rng.randn(c)).astype(np.float32)

    p, r, o = {}, {}, {}
    for d, convs in ((p, [(10, 3, 3), (16, 10, 3), (32, 16, 3)]),
                     (r, [(28, 3, 3), (48, 28, 3), (64, 48, 2)]),
                     (o, [(32, 3, 3), (64, 32, 3), (64, 64, 3), (128, 64, 2)])):
        for i, (co, ci, k) in enumerate(convs, start=1):
            conv(d, f"features.conv{i}", co, ci, k)
            prelu(d, f"features.prelu{i}", co)
    conv(p, "conv4_1", 2, 32, 1)
    conv(p, "conv4_2", 4, 32, 1)
    linear(r, "features.conv4", 128, 64 * 9)
    prelu(r, "features.prelu4", 128)
    linear(r, "conv5_1", 2, 128)
    linear(r, "conv5_2", 4, 128)
    linear(o, "features.conv5", 256, 128 * 9)
    prelu(o, "features.prelu5", 256)
    for name, n in (("conv6_1", 2), ("conv6_2", 4), ("conv6_3", 10)):
        linear(o, name, n, 256)
    paths = []
    for name, d in (("pnet", p), ("rnet", r), ("onet", o)):
        np.save(root / f"{name}.npy", d, allow_pickle=True)
        paths.append(root / f"{name}.npy")
    return paths


def test_convert_mtcnn_npy_matches_jax(tmp_path):
    paths = _release_files(tmp_path, 13)
    got, ref = mtcnn.convert_mtcnn_npy(*paths), jmtcnn.convert_mtcnn_npy(*paths)
    for a, b in zip(got, ref):
        _tree_equal(a, b)
    # The trees fill the port's nets (every name and shape).
    for tree, cls in zip(got, (mtcnn.PNet, mtcnn.RNet, mtcnn.ONet)):
        load_jax_variables(cls(), tree)


@pytest.fixture(scope="module")
def detectors():
    trees = [_net_variables(name, seed) for name, seed in (("pnet", 21), ("rnet", 22),
                                                           ("onet", 23))]
    return mtcnn.MTCNN(*trees, device="cpu"), jmtcnn.MTCNN(*trees)


@pytest.mark.parametrize("thresholds", [(0.6, 0.7, 0.8), (0.15, 0.25, 0.35)],
                         ids=["detect-defaults", "align-thresholds"])
def test_detect_matches_jax(detectors, thresholds):
    port, ref = detectors
    img = np.asarray(frame(14, (150, 130)))
    boxes, lms = port.detect(img, thresholds=thresholds)
    rboxes, rlms = ref.detect(img, thresholds=thresholds)
    assert boxes.shape == rboxes.shape and lms.shape == rlms.shape
    if thresholds[0] < 0.5:
        assert len(rboxes), "the seeded nets find no face at the lowered thresholds"
    np.testing.assert_allclose(boxes, rboxes, rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(lms, rlms, rtol=0, atol=BOX_ATOL)


def test_align_matches_jax(detectors):
    port, ref = detectors
    img = np.asarray(frame(15, (150, 130)))
    face, tfm = port.align(img)
    rface, rtfm = ref.align(img)
    assert (face is None) == (rface is None)
    assert face is not None, "the seeded nets find no face to align on the test image"
    assert face.shape == (112, 112, 3) and face.dtype == np.uint8
    np.testing.assert_allclose(tfm, rtfm, rtol=0, atol=BOX_ATOL)
    assert np.abs(face.astype(int) - rface.astype(int)).max() <= 1


def test_from_npy_detects_as_jax(tmp_path):
    paths = _release_files(tmp_path, 16)
    port, ref = mtcnn.MTCNN.from_npy(*paths, device="cpu"), jmtcnn.MTCNN.from_npy(*paths)
    img = np.asarray(frame(17, (150, 130)))  # the size of the tests above: their ops compiled
    for a, b in zip(port.detect(img, thresholds=(0.15, 0.25, 0.35)),
                    ref.detect(img, thresholds=(0.15, 0.25, 0.35))):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=BOX_ATOL)
