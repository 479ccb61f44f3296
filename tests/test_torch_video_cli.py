"""The port's video CLIs (`inference_on_video`, `compute_landmarks_transforms`)
against the JAX package's, both in this process, on the CPU.

dlib and its model are absent: `get_dlib_detector` is replaced in both
packages by one fake detector and predictor whose 68 points are
`test_torch_video.landmarks_of` of the frame. The video is an MJPG ``.avi``
of 8 seeded frames written with cv2 (both packages read it with cv2). The
ReStyle checkpoint is an e4e coach checkpoint in the numpy format: a
seeded encoder on the 8-layer IR-SE trunk (each package's encoder class
with ``num_layers=8``, as `test_torch_encoders.py` runs RestyleNet) and a
slim SG3-R 64² decoder (4 layers of 16 channels), the JAX package's init
seeded. No ffmpeg backend is installed, so the mp4s are PNG frames
(`generate_mp4`'s fallback), which both packages write alike.

Tolerances: alignment, crops and the landmark transforms are the same
numpy, PIL and scipy operations in both packages: equal. The edited
latents (ReStyle codes from fp32 decodes, plus the direction) within 1e-4
of max |ref|, `test_torch_inference.py`'s codes tolerance. The smoothed
and edited frames render in `sg3_r_config`'s bf16 policy (every layer of
so small a generator), so they are held within one level plus
`RANGE_RENDER_TOL` of max |ref| (the generator tests' bf16 image
tolerance), as the other CLI tests hold their bf16 PNGs.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import stylegan3_editing_tpu.configs as jconfigs
from stylegan3_editing_tpu.models.encoders import restyle as jrestyle
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu.runtime import checkpoint as jckpt
from stylegan3_editing_tpu.utils import alignment_utils as jau
from stylegan3_editing_tpu.utils import inference_utils as jinference
from stylegan3_editing_tpu_torch import configs
from stylegan3_editing_tpu_torch.editing.interfacegan import RANGE_RENDER_TOL
from stylegan3_editing_tpu_torch.models.encoders import restyle as trestyle
from stylegan3_editing_tpu_torch.scripts import compute_landmarks_transforms, inference_on_video
from stylegan3_editing_tpu_torch.training.options import E4eTrainOptions
from stylegan3_editing_tpu_torch.utils import alignment_utils as au
from test_torch_encoders import ENCODERS, encoder_variables, generator_variables, jax_restyle
from test_torch_styleclip_cli import jax_cli
from test_torch_video import frame, landmarks_of

CODES_TOL = 1e-4
DECODER = dict(channel_base=1024, channel_max=16, num_layers=3)
ENCODER = "ProgressiveBackboneEncoder"
N_FRAMES = 6


class _FakeDlib:
    """dlib's detector and predictor, as far as the CLIs use them."""

    class _Point:
        def __init__(self, x, y):
            self.x, self.y = int(x), int(y)

    class _Shape:
        def __init__(self, lm):
            self._lm = lm

        def parts(self):
            return [_FakeDlib._Point(x, y) for x, y in self._lm]

    def detector(self, arr, upsample):
        assert upsample == 1
        return ["face"]

    def predictor(self, arr, det):
        return self._Shape(landmarks_of(Image.fromarray(arr)))


def _fake_dlib(path):
    fake = _FakeDlib()
    return fake.detector, fake.predictor


@pytest.fixture
def no_dlib(monkeypatch):
    for mod in (au, jau):
        monkeypatch.setattr(mod, "get_dlib_detector", _fake_dlib)


def _jitted(fn):
    """``fn(model, variables, *arrays, **options)`` of the JAX package under
    one `jax.jit` per model and options (eagerly, its op-by-op compiles take
    most of the test's time); the same computation."""
    cache = {}

    def call(model, variables, *arrays, landmarks_transform=None, **options):
        key = (id(model), tuple(sorted(options.items())))
        if key not in cache:
            cache[key] = jax.jit(lambda v, a, t: fn(model, v, *a, landmarks_transform=t, **options)
                                 if t is not None else fn(model, v, *a, **options))
        return cache[key](variables, arrays, landmarks_transform)

    return call


def _write_video(path):
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (160, 128))
    assert writer.isOpened()
    for i in range(N_FRAMES):
        writer.write(np.asarray(frame(40 + i % 3, (160, 128)))[:, :, ::-1])
    writer.release()


@pytest.fixture(scope="module")
def video_runs(tmp_path_factory):
    """`inference_on_video` of both packages on one video: 6 frames, batches
    of 3, one ReStyle iteration, an expansion of 8, 4, 6 and 2 pixels, and
    one InterFaceGAN direction over (-2, 3). The JAX CLI's ReStyle calls run
    under `jax.jit` (`_jitted`)."""
    root = tmp_path_factory.mktemp("video_cli")
    _write_video(root / "clip.avi")
    cfg = jcfg.sg3_r_config(64, **DECODER)
    enc = encoder_variables(8, cfg.num_ws, seed=41)
    gen = generator_variables(cfg, seed=42)
    variables = {"params": {"encoder": enc["params"], "decoder": gen["params"]},
                 "batch_stats": {"encoder": enc["batch_stats"]},
                 "buffers": {"decoder": gen["buffers"]}, "ema": {"decoder": gen["ema"]}}
    opts = E4eTrainOptions(output_size=64, **{f"decoder_{k}": v for k, v in DECODER.items()})
    (root / "boundaries").mkdir()
    d = np.random.RandomState(43).randn(1, 512).astype(np.float32)
    np.save(root / "boundaries" / "age_boundary.npy", d / np.linalg.norm(d))
    options = dict(video_path=str(root / "clip.avi"), checkpoint_path=str(root / "ckpt"),
                   n_iters_per_batch=1, batch_size=3, expansion_amounts=(8, 4, 6, 2),
                   interfacegan_directions=["age"], interfacegan_ranges=["(-2_3)"])
    jcli = jax_cli("inference_on_video")

    class Restyle(jinference.RestyleNet):  # the JAX RestyleNet on the 8-layer trunk
        def __new__(cls, decoder_cfg, encoder_type, n_styles, input_nc):
            return jax_restyle(dataclasses.asdict(decoder_cfg), encoder_type, n_styles, 8)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt.jax, "process_count", lambda: 2)  # the JAX package's numpy format
        jckpt.save_pytree(root / "ckpt", {"variables": variables},
                          {"opts": dataclasses.asdict(opts), "is_e4e": True})
    with pytest.MonkeyPatch.context() as mp:
        for mod in (au, jau):
            mp.setattr(mod, "get_dlib_detector", _fake_dlib)
        mp.setitem(configs.model_paths, "interfacegan_boundaries", root / "boundaries")
        mp.setitem(jconfigs.model_paths, "interfacegan_boundaries", root / "boundaries")
        mp.setitem(trestyle.ENCODER_TYPES, ENCODER,
                   functools.partial(ENCODERS[ENCODER][1], num_layers=8))
        mp.setattr(jinference, "RestyleNet", Restyle)
        mp.setattr(jcli, "get_average_image", _jitted(jrestyle.get_average_image))
        mp.setattr(jcli, "run_restyle_iterations", _jitted(jrestyle.run_restyle_iterations))
        with torch.no_grad():
            latents, smoothed = inference_on_video.run_inference_on_video(
                inference_on_video.VideoConfig(output_path=str(root / "port"), device="cpu",
                                               **options))
        jcli.run_inference_on_video(jcli.VideoConfig(output_path=str(root / "jax"), **options))
    return root, latents, smoothed


def _files(out):
    return sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())


def _same_png(a, b):
    return np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


def test_video_cli_writes_the_jax_files(video_runs):
    root, latents, smoothed = video_runs
    port, jax_out = root / "port", root / "jax"
    assert _files(port) == _files(jax_out)
    assert len(latents) == N_FRAMES and len(smoothed) == N_FRAMES - 4
    assert smoothed[0].shape == (6 + 64 + 2, 8 + 64 + 4, 3) and smoothed[0].dtype == np.uint8
    for sub in ("raw_frames", "aligned_frames", "cropped_frames"):
        names = sorted(p.name for p in (jax_out / sub).iterdir())
        assert len(names) == N_FRAMES
        assert all(_same_png(port / sub / n, jax_out / sub / n) for n in names), sub
    got, ref = (np.load(d / "landmarks_transforms.npy", allow_pickle=True).item()
                for d in (port, jax_out))
    assert list(got) == list(ref) and len(ref) == N_FRAMES
    for name in ref:
        assert got[name][0] == ref[name][0]
        for a, b in zip(got[name][1:], ref[name][1:]):
            np.testing.assert_array_equal(a, b)


def test_video_cli_latents_and_frames_match_jax(video_runs):
    root, _, _ = video_runs
    port, jax_out = root / "port", root / "jax"
    for tag in ("start", "end"):
        got, ref = (np.load(d / "latents" / f"latents_age_{tag}.npy") for d in (port, jax_out))
        err = np.abs(got - ref).max()
        print(f"latents {tag}: max abs err {err:.3g} (tol {CODES_TOL * np.abs(ref).max():.3g})")
        assert got.shape == ref.shape == (N_FRAMES, 5, 512) and err <= CODES_TOL * np.abs(ref).max()
    pngs = [p for p in _files(jax_out) if p.endswith(".png") and "_frames/" in p
            and p.split("/")[0].endswith("_frames") and not p.startswith(("raw", "aligned",
                                                                         "cropped"))]
    assert len(pngs) == N_FRAMES + 5 * (N_FRAMES - 4)  # input, smoothed, 2 edits + 2 coupled
    worst = 0.0
    for name in pngs:
        got, ref = (np.asarray(Image.open(d / name), np.float64) for d in (port, jax_out))
        tol = 1 + RANGE_RENDER_TOL * np.abs(ref - 127.5).max()
        worst = max(worst, np.abs(got - ref).max() / tol)
        assert got.shape == ref.shape and np.abs(got - ref).max() <= tol, name
    print(f"video frames: worst error {worst:.3f} of its tolerance")


def test_compute_landmarks_transforms_cli_matches_jax(video_runs, no_dlib, tmp_path):
    """Both CLIs on the raw, aligned and cropped frames that the video run
    wrote: the same ``landmarks_transforms.npy``."""
    root = video_runs[0] / "jax"
    kw = dict(raw_root=str(root / "raw_frames"), aligned_root=str(root / "aligned_frames"),
              cropped_root=str(root / "cropped_frames"))
    got = compute_landmarks_transforms.main([f"--{k}={v}" for k, v in kw.items()]
                                            + [f"--output_root={tmp_path / 'port'}"])
    jcli = jax_cli("compute_landmarks_transforms")
    jcli.run(jcli.LandmarksOptions(output_root=str(tmp_path / "jax"), **kw))
    ref = np.load(tmp_path / "jax" / "landmarks_transforms.npy", allow_pickle=True).item()
    back = np.load(tmp_path / "port" / "landmarks_transforms.npy", allow_pickle=True).item()
    assert list(got) == list(back) == list(ref) and len(ref) == N_FRAMES
    for name in ref:
        for a, b, c in zip(got[name], back[name], ref[name]):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
