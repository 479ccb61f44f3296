"""Parity of the port's alignment utilities and video pipeline with the JAX
package's, on the CPU.

Alignment runs the same numpy, PIL and scipy operations in both packages,
so its results are held equal: quads, transforms, crops (PNG bytes) and the
landmark transforms' files. Landmarks come from synthetic 68-point
functions (`synthetic_landmarks`, `landmarks_of`; dlib and its model are
absent), one function for both packages.

The generator is the JAX editing tests' tiny one (`tests/test_editing.py`:
32², 5 layers of 32 channels, fp32), the JAX package's init with its zero
leaves and EMAs seeded (`generator_variables`), copied into the port.
Tolerances: smoothing, a few fp32 operations on the same numbers, 1e-6 of
max |ref|; rendered uint8 frames within one level of 255 (images agree to
1e-4, as in the generator tests, which can round to the next level);
latents exactly where they are the same fp32 sums, else 1e-5 of max |ref|;
StyleCLIP video edits as `test_torch_styleclip.py` (1e-4 on images).
The video CLIs are held in `test_torch_video_cli.py`.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan3_editing_tpu.editing import styleclip_global as jsc
from stylegan3_editing_tpu.models.backbones import clip as jclip
from stylegan3_editing_tpu.models.sg3 import Generator as JaxGenerator
from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu.utils import alignment_utils as jau
from stylegan3_editing_tpu.utils import common as jcommon
from stylegan3_editing_tpu.video import post_processing as jpp
from stylegan3_editing_tpu.video import video_config as jvc
from stylegan3_editing_tpu.video import video_editor as jve
from stylegan3_editing_tpu.video import video_handler as jvh
from stylegan3_editing_tpu_torch.editing import styleclip_global as sc
from stylegan3_editing_tpu_torch.models.backbones import clip
from stylegan3_editing_tpu_torch.models.sg3 import Generator, SG3Config, load_jax_variables
from stylegan3_editing_tpu_torch.utils import alignment_utils as au
from stylegan3_editing_tpu_torch.utils import common
from stylegan3_editing_tpu_torch.video import post_processing as pp
from stylegan3_editing_tpu_torch.video import video_config as vc
from stylegan3_editing_tpu_torch.video import video_editor as ve
from stylegan3_editing_tpu_torch.video import video_handler as vh
from test_torch_clip import TINY as CLIP_TINY
from test_torch_clip import clip_variables
from test_torch_encoders import generator_variables

torch.set_num_threads(1)

SMOOTH_RTOL = 1e-6
LATENT_RTOL = 1e-5
IMAGE_ATOL = 1e-4
TINY = dict(img_resolution=32, channel_base=512, channel_max=32, num_layers=4,
            num_critical=2, use_bf16=False)  # tests/test_editing.py's tiny_cfg


def synthetic_landmarks(cx=256.0, cy=256.0, eye_dist=80.0, angle_deg=0.0):
    """tests/test_video.py's 68-point stub: eyes and mouth corners placed,
    the rest zero."""
    lm = np.zeros((68, 2))
    theta = np.radians(angle_deg)
    rot = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    left = np.array([-eye_dist / 2, 0.0]) @ rot.T + [cx, cy]
    right = np.array([eye_dist / 2, 0.0]) @ rot.T + [cx, cy]
    mouth = np.array([0.0, eye_dist]) @ rot.T + [cx, cy]
    lm[36:42] = left
    lm[42:48] = right
    lm[48] = mouth + [-20, 0]
    lm[54] = mouth + [20, 0]
    return lm


def landmarks_of(img):
    """A deterministic landmark function of a PIL image, in dlib's integer
    pixels: the face's centre, size and tilt follow the image's size and
    the mean of its red and green channels."""
    arr = np.asarray(img.convert("RGB"), np.float64)
    h, w = arr.shape[:2]
    r, g = arr[..., 0].mean() / 255, arr[..., 1].mean() / 255
    lm = synthetic_landmarks(cx=w * (0.45 + 0.1 * r), cy=h * (0.4 + 0.1 * g),
                             eye_dist=w * 0.22, angle_deg=30 * (r - g))
    return np.rint(lm).astype(np.int64)


def frame(seed, size=(160, 128)):
    """A smooth seeded RGB frame (PIL)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size[1], :size[0]] / max(size)
    arr = np.stack([np.sin(xx * rng.uniform(2, 6) + rng.uniform(0, 6)) for _ in range(3)], -1)
    arr = arr * 0.5 + np.cos(yy * 4)[..., None] * 0.3 + rng.uniform(-0.3, 0.3, 3)
    return Image.fromarray(np.uint8(np.clip(arr * 100 + 128, 0, 255)))


def _equal_images(a, b):
    assert a.size == b.size and np.array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------- alignment

@pytest.mark.parametrize("angle", [0.0, -12.5, 33.0])
def test_alignment_geometry_matches_jax(angle):
    lm = synthetic_landmarks(cx=240.3, cy=270.9, eye_dist=77.0, angle_deg=angle)
    for fn in ("get_alignment_positions_from_landmarks", "get_eyes_coors"):
        for a, b in zip(getattr(au, fn)(lm), getattr(jau, fn)(lm)):
            np.testing.assert_array_equal(a, b)
    c, x, y = au.get_alignment_positions_from_landmarks(lm, eyes_distance_only=False)
    for a, b in zip((c, x, y), jau.get_alignment_positions_from_landmarks(
            lm, eyes_distance_only=False)):
        np.testing.assert_array_equal(a, b)
    for fn, args in (("get_alignment_transformation", (c, x, y)),
                     ("get_fixed_cropping_transformation", (c, x))):
        (q, s), (jq, js) = getattr(au, fn)(*args), getattr(jau, fn)(*args)
        np.testing.assert_array_equal(q, jq)
        assert s == js
    other = synthetic_landmarks(angle_deg=angle / 2 - 7)
    eyes = (*au.get_eyes_coors(lm), *au.get_eyes_coors(other))
    assert au.get_rotation_from_eyes(*eyes) == jau.get_rotation_from_eyes(*eyes)


@pytest.mark.parametrize("case", ["align", "crop", "crop_shifted", "padded"])
def test_crops_match_jax(case):
    """The aligned and fixed crops, a randomly shifted crop, and a face near
    the corner whose quad leaves the image (the reflect-pad and blur path)."""
    img = frame(1, (300, 260))
    lm = synthetic_landmarks(cx=150, cy=120, eye_dist=70, angle_deg=8)
    if case == "align":
        got, ref = (m.align_face_from_landmarks(img, lm, 96) for m in (au, jau))
    elif case == "crop":
        got, ref = (m.crop_face_from_landmarks(img, lm, output_size=96) for m in (au, jau))
    elif case == "crop_shifted":
        got, ref = (m.crop_face_from_landmarks(img, lm, 0.05, 96, np.random.RandomState(3))
                    for m in (au, jau))
    else:
        lm = synthetic_landmarks(cx=30, cy=25, eye_dist=60, angle_deg=-20)
        c, x, _ = au.get_alignment_positions_from_landmarks(lm)
        quad, qsize = au.get_fixed_cropping_transformation(c, x)
        assert quad.min() < 0
        got, ref = (m.crop_face_by_transform(img, quad, qsize, 64, 128) for m in (au, jau))
    assert got.size == (96, 96) if case != "padded" else got.size == (64, 64)
    _equal_images(got, ref)


@pytest.mark.parametrize("detect", [False, True], ids=["analytic", "landmark_fn"])
def test_stylegan_transform_from_landmarks_matches_jax(detect):
    cropped, aligned = frame(2, (128, 128)), frame(3, (128, 128))
    lm_u, lm_a = landmarks_of(cropped), landmarks_of(aligned)
    fn = landmarks_of if detect else None
    got = au.get_stylegan_transform_from_landmarks(lm_u, lm_a, aligned, landmark_fn=fn)
    ref = jau.get_stylegan_transform_from_landmarks(lm_u, lm_a, aligned, landmark_fn=fn)
    assert got[0] == ref[0] and 0 < got[0] < 360
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[2] @ got[3], np.eye(3), atol=1e-12)


def test_get_dlib_detector_raises_without_dlib():
    with pytest.raises(ImportError, match="dlib"):
        au.get_dlib_detector("shape_predictor_68_face_landmarks.dat")


# ----------------------------------------------------------- config, handler

def test_video_config_parsing_matches_jax():
    kw = dict(interfacegan_directions=["age", "smile"], interfacegan_ranges=["(-4_5)", "(2_3)"],
              styleclip_directions=["smiling", "old"],
              styleclip_alpha_betas=["(4_0.13)", "(-1.5_0)"])
    got, ref = vc.VideoConfig(**kw), jvc.VideoConfig(**kw)
    assert got.interfacegan_edits() == ref.interfacegan_edits()
    assert got.styleclip_edits() == ref.styleclip_edits()
    assert got.styleclip_edits()[1] == vc.StyleCLIPEdit("old", -1.5, 0.0)
    assert got.device is None and got.batch_size == ref.batch_size == 4
    for bad in (dict(interfacegan_directions=["age"]),
                dict(styleclip_directions=["a"], styleclip_alpha_betas=["(1_2)", "(3_4)"])):
        with pytest.raises(ValueError):
            vc.VideoConfig(**bad).interfacegan_edits() if "interfacegan_directions" in bad \
                else vc.VideoConfig(**bad).styleclip_edits()


@pytest.fixture(scope="module")
def handled(tmp_path_factory):
    """Both packages' `VideoHandler` (align and crop) and `LandmarksHandler`
    on 5 PNG frames the test writes, at a 96² output."""
    root = tmp_path_factory.mktemp("handler")
    (root / "raw").mkdir()
    paths = []
    for i in range(5):
        paths.append(root / "raw" / f"{i:04d}.png")
        frame(10 + i, (200, 160)).save(paths[-1])
    out = {}
    for name, mod in (("port", vh), ("jax", jvh)):
        h = mod.VideoHandler("unused.mp4", root / name, landmarks_of, output_size=96)
        aligned, cropped = h.align_frames(paths), h.crop_frames(paths)
        lh = mod.LandmarksHandler(root / name, landmark_fn=landmarks_of)
        out[name] = (aligned, cropped, lh.get_landmarks_transforms(
            paths, h.cropped_frames_path, h.aligned_frames_path), lh)
    return root, paths, out


def test_video_handler_frames_match_jax(handled):
    root, paths, out = handled
    for i in (0, 1):
        got, ref = out["port"][i], out["jax"][i]
        assert [p.name for p in got] == [p.name for p in ref] == [p.name for p in paths]
        for a, b in zip(got, ref):
            _equal_images(Image.open(a), Image.open(b))
            assert Image.open(a).size == (96, 96)


def test_landmarks_handler_matches_jax(handled):
    root, paths, out = handled
    got, ref = out["port"][2], out["jax"][2]
    assert list(got) == list(ref) == [p.name for p in paths]
    for name in ref:
        assert got[name][0] == ref[name][0]
        for a, b in zip(got[name][1:], ref[name][1:]):
            np.testing.assert_array_equal(a, b)
    lh = out["port"][3]
    assert lh.path == root / "port" / "landmarks_transforms.npy" and lh.path.exists()
    cached = vh.LandmarksHandler(root / "port").get_landmarks_transforms(paths, None, None)
    assert list(cached) == list(ref)  # read back from the cache, no landmark function


# --------------------------------------------------------------- smoothing

def test_smoothing_matches_jax():
    rng = np.random.RandomState(20)
    x = rng.randn(10, 6, 5).astype(np.float32)
    ref = np.asarray(jpp.smooth_ws(x))
    for got in (pp.smooth_ws(x), pp.smooth_ws(torch.from_numpy(x)).numpy()):
        assert got.shape == (6, 6, 5) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=SMOOTH_RTOL * np.abs(ref).max())
    frames = [{"input": rng.randn(1, 4).astype(np.float32),
               "L0": rng.randn(1, 8).astype(np.float32)} for _ in range(7)]
    got, ref = pp.smooth_s(frames), jpp.smooth_s(frames)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k in r:
            assert g[k].shape == (1, r[k].shape[-1])
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]), rtol=0,
                                       atol=SMOOTH_RTOL * np.abs(np.asarray(r[k])).max())
    lat = rng.randn(5, 12, 4).astype(np.float32)
    np.testing.assert_array_equal(pp.average_fine_layers(lat, 9), jpp.average_fine_layers(lat, 9))
    np.testing.assert_array_equal(pp.average_fine_layers(lat, 4), jpp.average_fine_layers(lat, 4))


def test_to_uint8_is_tensor2im():
    x = np.random.RandomState(21).randn(1, 9, 7, 3).astype(np.float32) * 1.3
    want = np.asarray(jcommon.tensor2im(x))
    for got in (common.to_uint8(x), common.to_uint8(torch.from_numpy(x)),
                np.asarray(common.tensor2im(x))):
        assert got.dtype == np.uint8 and np.array_equal(got, want)


# --------------------------------------------------------- renders, editors

@pytest.fixture(scope="module")
def pair():
    cfg = JSG3Config(**TINY)
    variables = generator_variables(cfg, seed=22)
    G = Generator(SG3Config(**TINY), device="cpu")
    load_jax_variables(G, variables)
    return JaxGenerator(cfg), variables, G


def _frames_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g, np.int64), np.asarray(r, np.int64)
        assert g.shape == r.shape and np.abs(g - r).max() <= 1


def _inputs(n, seed, num_ws):
    rng = np.random.RandomState(seed)
    latents = (rng.randn(n, num_ws, 512) * 0.5).astype(np.float32)
    transforms = [jcommon.generate_random_transform(0.05, 6, rng).astype(np.float32)
                  for _ in range(n)]
    return latents, transforms


def test_postprocess_and_smooth_inversions_matches_jax(pair):
    """7 frames with landmark transforms and an uneven expansion → 3
    smoothed, expanded frames; and without transforms (the identity)."""
    jmodel, variables, G = pair
    latents, transforms = _inputs(7, 23, G.num_ws)
    named = {f"{i:04d}.png": latents[i] for i in range(7)}
    amounts = (4, 2, 3, 1)
    got = pp.postprocess_and_smooth_inversions(named, transforms, G, 32, amounts)
    ref = jpp.postprocess_and_smooth_inversions(named, transforms, jmodel, variables, 32, amounts)
    assert got[0].shape == (3 + 32 + 1, 4 + 32 + 2, 3) and got[0].dtype == np.uint8
    _frames_close(got, ref)
    _frames_close(pp.postprocess_and_smooth_inversions(named, None, G, 32),
                  jpp.postprocess_and_smooth_inversions(named, None, jmodel, variables, 32))


def test_interfacegan_video_editor_matches_jax(pair, tmp_path):
    jmodel, variables, G = pair
    latents, transforms = _inputs(6, 24, G.num_ws)
    direction = np.random.RandomState(25).randn(1, 512).astype(np.float32)
    ed = ve.InterFaceGANVideoEditor(G, 32, tmp_path / "port", {"age": direction}, (2, 0, 1, 3))
    jed = jve.InterFaceGANVideoEditor(jmodel, variables, 32, tmp_path / "jax", {"age": direction},
                                      (2, 0, 1, 3))
    got, ref = ed.edit("age", -2, 3, latents, transforms), jed.edit("age", -2, 3, latents,
                                                                    transforms)
    for g, r in zip(got[:2], ref[:2]):
        assert tuple(g.shape) == (6, 32, 32, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=IMAGE_ATOL)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g, np.asarray(r), rtol=0,
                                   atol=LATENT_RTOL * np.abs(np.asarray(r)).max())
    for tag in ("start", "end"):
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / "latents" / f"latents_age_{tag}.npy"),
            np.load(tmp_path / "jax" / "latents" / f"latents_age_{tag}.npy"))
    smoothed_t = np.asarray(jpp.smooth_ws(np.stack(transforms)))
    _frames_close(ed.postprocess_and_smooth_edits(got[3], smoothed_t),
                  jed.postprocess_and_smooth_edits(ref[3], smoothed_t))


def test_styleclip_video_editor_matches_jax(pair, tmp_path):
    """`StyleCLIPVideoEditor.edit` over 5 frames, with and without their
    landmark transforms, from one global direction (a seeded ``delta_i_c``,
    the tiny CLIP, a stub tokenizer as the JAX editing test's)."""
    jmodel, variables, G = pair
    latents, transforms = _inputs(5, 26, G.num_ws)
    jclip_model = jclip.CLIP(**CLIP_TINY)
    cvars = clip_variables(jclip_model, 27)
    clip_model = clip.CLIP(**CLIP_TINY, device="cpu")
    load_jax_variables(clip_model, cvars)
    with torch.no_grad():
        all_s = G.w2s(torch.from_numpy(latents))
    s_std = {k: np.abs(v.numpy()).mean(0) + 0.1 for k, v in all_s.items()}
    s_avg = {k: v.numpy().mean(0, keepdims=True) for k, v in all_s.items()}
    s_std, s_avg = ({k: d[k] for k in sc.s_key_order(d)} for d in (s_std, s_avg))
    rng = np.random.RandomState(28)
    d_ic = rng.randn(sum(v.shape[-1] for v in s_std.values()), 32).astype(np.float32)

    class Tok:
        def tokenize(self, texts):
            return np.asarray([[49406] + [100 + len(t) % 7] * 5 + [49407] + [0] * 70
                               for t in texts], np.int32)

    gd = sc.StyleCLIPGlobalDirection(d_ic, s_std, ["a photo of a {}."], s_avg, clip_model, Tok())
    jgd = jsc.StyleCLIPGlobalDirection(d_ic, s_std, ["a photo of a {}."], s_avg, jclip_model,
                                       cvars, Tok())
    ed = ve.StyleCLIPVideoEditor(G, 32, tmp_path, gd)
    jed = jve.StyleCLIPVideoEditor(jmodel, variables, 32, tmp_path, jgd)
    for t in (transforms, None):
        img, edited = ed.edit("smiling face", 3.0, 0.05, latents, landmarks_transforms=t)
        jimg, jedited = jed.edit("smiling face", 3.0, 0.05, latents, landmarks_transforms=t)
        assert tuple(img.shape) == (5, 32, 32, 3)
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0, atol=IMAGE_ATOL)
        for k in jedited:
            r = np.asarray(jedited[k])
            np.testing.assert_allclose(edited[k].numpy(), r, rtol=0,
                                       atol=LATENT_RTOL * np.abs(r).max())
