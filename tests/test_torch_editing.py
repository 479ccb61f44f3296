"""Parity of the port's InterFaceGAN editing, transform helpers and adaptive
pooling with the JAX package, on the CPU.

The generator is the JAX editing tests' tiny one (`tests/test_editing.py`,
32², 5 layers of 32 channels, fp32), its weights the JAX package's init
with the zero leaves and EMAs drawn from a seed (`generator_variables` of
`test_torch_encoders.py`), copied into the port by `load_jax_variables`.
Images are held at atol 1e-4, as in the generator tests (fp32 convs and
matmuls sum in another order in the two frameworks, through 5 layers);
latents, which are sums of the same fp32 numbers, exactly; the transform
helpers and the SVM boundary, numpy in both packages, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.editing import interfacegan as jig
from stylegan3_editing_tpu.models.sg3 import Generator as JaxGenerator
from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu.ops import image as jimage
from stylegan3_editing_tpu.utils import common as jcommon
from stylegan3_editing_tpu_torch.editing import FaceEditor, pseudo_align_latents, train_boundary
from stylegan3_editing_tpu_torch.models.sg3 import Generator, SG3Config, load_jax_variables
from stylegan3_editing_tpu_torch.ops.image import adaptive_avg_pool2d
from stylegan3_editing_tpu_torch.utils import common
from test_torch_encoders import generator_variables

IMAGE_ATOL = 1e-4
TINY = dict(img_resolution=32, channel_base=512, channel_max=32, num_layers=4,
            num_critical=2, use_bf16=False)  # tests/test_editing.py's tiny_cfg


@pytest.fixture(scope="module")
def editors():
    jgen = JaxGenerator(JSG3Config(**TINY))
    variables = generator_variables(JSG3Config(**TINY), seed=40)
    tgen = Generator(SG3Config(**TINY), device="cpu")
    load_jax_variables(tgen, variables)
    rng = np.random.RandomState(41)
    directions = {"age": rng.randn(1, 512).astype(np.float32),
                  "smile": rng.randn(SG3Config(**TINY).num_ws, 512).astype(np.float32)}
    ws = rng.randn(2, SG3Config(**TINY).num_ws, 512).astype(np.float32)
    return (jig.FaceEditor(jgen, variables, directions=directions),
            FaceEditor(tgen, directions=directions), ws)


def _close(got, ref, atol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    print(f"{what}: max abs err {err:.3g} (atol {atol:g})")
    assert np.asarray(got).shape == np.asarray(ref).shape
    assert err <= atol, what


@pytest.mark.parametrize("direction", ["age", "smile"])
def test_face_editor_factor_range_matches_jax(editors, direction):
    """A factor range is one batched synthesis: each factor's images and
    latents against the JAX editor's (a [1, 512] and a [num_ws, 512]
    direction)."""
    jed, ted, ws = editors
    ref_imgs, ref_lat = jed.edit(ws, direction, factor_range=(-2, 3))
    with torch.no_grad():
        imgs, lat = ted.edit(torch.from_numpy(ws), direction, factor_range=(-2, 3))
    assert len(imgs) == len(lat) == 5
    for f, (a, ra, la, rl) in enumerate(zip(imgs, ref_imgs, lat, ref_lat)):
        np.testing.assert_array_equal(la.numpy(), np.asarray(rl))
        _close(a, ra, IMAGE_ATOL, f"{direction} factor {f - 2}")
    np.testing.assert_array_equal(lat[2].numpy(), ws)


def test_face_editor_single_factor_matches_jax_and_the_range(editors):
    jed, ted, ws = editors
    ref_img, ref_lat = jed.edit(ws, "age", factor=-2.0)
    with torch.no_grad():
        img, lat = ted.edit(torch.from_numpy(ws), "age", factor=-2.0)
        imgs, _ = ted.edit(torch.from_numpy(ws), "age", factor_range=(-2, 0))
    np.testing.assert_array_equal(lat.numpy(), np.asarray(ref_lat))
    _close(img, ref_img, IMAGE_ATOL, "single factor")
    _close(img, imgs[0], 1e-5, "single factor vs its slot in the range")


def test_face_editor_user_transform_matches_jax(editors):
    """``apply_user_transformations`` with a given transform, over a range."""
    jed, ted, ws = editors
    m = common.generate_random_transform(rng=np.random.RandomState(3))
    ref_imgs, _ = jed.edit(ws, "age", factor_range=(0, 2), user_transforms=m,
                           apply_user_transformations=True)
    with torch.no_grad():
        imgs, _ = ted.edit(torch.from_numpy(ws), "age", factor_range=(0, 2),
                           user_transforms=m, apply_user_transformations=True)
        plain, _ = ted.edit(torch.from_numpy(ws), "age", factor_range=(0, 2))
    for a, ra in zip(imgs, ref_imgs):
        _close(a, ra, IMAGE_ATOL, "user transform")
    assert not np.allclose(imgs[0].numpy(), plain[0].numpy(), atol=1e-3)


def test_face_editor_reads_boundary_files(tmp_path):
    """Directions come from ``<name>_boundary.npy`` in ``boundaries_dir``;
    names without a file are left out, as in the JAX editor."""
    rng = np.random.RandomState(5)
    for name in ("age", "pose"):
        np.save(tmp_path / f"{name}_boundary.npy", rng.randn(1, 512).astype(np.float32))
    ted = FaceEditor(Generator(SG3Config(**TINY), device="cpu"), boundaries_dir=tmp_path)
    jed = jig.FaceEditor(JaxGenerator(JSG3Config(**TINY)), None, boundaries_dir=tmp_path)
    assert sorted(ted.directions) == sorted(jed.directions) == ["age", "pose"]
    for name in ted.directions:
        np.testing.assert_array_equal(ted.directions[name].numpy(),
                                      np.asarray(jed.directions[name]))


def test_pseudo_align_latents_matches_jax():
    rng = np.random.RandomState(6)
    ws, w_avg = rng.randn(3, 6, 512).astype(np.float32), rng.randn(512).astype(np.float32)
    got = pseudo_align_latents(torch.from_numpy(ws), torch.from_numpy(w_avg))
    ref = jig.pseudo_align_latents(jnp.asarray(ws), jnp.asarray(w_avg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ws[:, 1:], got[:, 1:].numpy())


def test_train_boundary_matches_jax():
    """The same seed gives the JAX normal, which recovers the planted one."""
    rng = np.random.RandomState(7)
    true_normal = np.zeros(16, np.float32)
    true_normal[3] = 1.0
    codes = rng.randn(400, 16).astype(np.float32)
    scores = (codes @ true_normal)[:, None]
    got = train_boundary(codes, scores, chosen_num_or_ratio=0.25, seed=3)
    ref = jig.train_boundary(codes, scores, chosen_num_or_ratio=0.25, seed=3)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (1, 16) and abs(float(got[0] @ true_normal)) > 0.95


@pytest.mark.parametrize("translate,angle", [((0.0, 0.0), 0.0), ((0.1, -0.2), 17.0),
                                             ((-0.3, 0.05), -90.0)])
def test_transform_helpers_match_jax(translate, angle):
    np.testing.assert_array_equal(common.make_transform(translate, angle),
                                  jcommon.make_transform(translate, angle))
    np.testing.assert_array_equal(common.get_identity_transform(),
                                  jcommon.get_identity_transform())
    seed = int(abs(angle)) + 1
    np.testing.assert_array_equal(
        common.generate_random_transform(0.2, 10, rng=np.random.RandomState(seed)),
        jcommon.generate_random_transform(0.2, 10, rng=np.random.RandomState(seed)))


def test_tensor2im_matches_jax():
    """numpy and torch inputs, NHWC and HWC, give the JAX package's image."""
    x = np.random.RandomState(8).uniform(-1.2, 1.2, (1, 9, 7, 3)).astype(np.float32)
    ref = np.asarray(jcommon.tensor2im(x))
    for arr in (x, x[0], torch.from_numpy(x), torch.from_numpy(x[0])):
        np.testing.assert_array_equal(np.asarray(common.tensor2im(arr)), ref)


def _pool_windows(x, out):
    """torch's AdaptiveAvgPool2d in float64, window by window: cell i
    averages rows floor(i·H/out) … ceil((i+1)·H/out) − 1 (columns alike)."""
    size = x.shape[1]
    lo = [i * size // out for i in range(out)]
    hi = [-(-(i + 1) * size // out) for i in range(out)]
    x = x.astype(np.float64)
    return np.stack([np.stack([x[:, lo[i]:hi[i], lo[j]:hi[j]].mean(axis=(1, 2))
                               for j in range(out)], axis=1) for i in range(out)], axis=1)


@pytest.mark.parametrize("size,out", [(1024, 256), (64, 256), (100, 256), (37, 8), (256, 256)])
def test_adaptive_avg_pool2d_matches_jax(size, out):
    """torch's windows, also where the sizes do not divide and pooling up
    (the tiny decoders' 64² and 100² to 256²). The port against the windows
    in float64 within 1e-6 (an fp32 mean of at most 36 values); the JAX
    package's pool sums an integral image in fp32, whose four corner terms
    each carry a few ulps of its largest entry, so the two agree within
    8·2⁻²⁴·max |integral image|."""
    x = np.random.RandomState(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    got = adaptive_avg_pool2d(torch.from_numpy(x), out)
    assert got.shape == (2, out, out, 3) and got.dtype == torch.float32
    _close(got, _pool_windows(x, out), 1e-6, f"adaptive_avg_pool2d {size} -> {out}, float64")
    integral = float(np.abs(np.cumsum(np.cumsum(x.astype(np.float64), 1), 2)).max())
    _close(got, jimage.adaptive_avg_pool2d(x, out), 8 * 2 ** -24 * integral,
           f"adaptive_avg_pool2d {size} -> {out}, JAX")
