"""Parity of the port's interpolation helpers, FOV expansion and video writer
with the JAX package's, on the CPU.

The generator is the JAX editing tests' tiny one (`tests/test_editing.py`:
32², 5 layers of 32 channels, fp32), its weights the JAX package's init
with the zero leaves and EMAs drawn from a seed (`generator_variables` of
`test_torch_encoders.py`), copied into the port by `load_jax_variables`.
Tolerances: the interpolation helpers, a few fp32 operations on the same
numbers, 1e-6; latents 1e-5 of max |ref| (two 512-wide matmuls summing in
another order); images 1e-4 absolute, as in the generator tests (fp32
convs and matmuls through 5 layers); PNG frames one level of 255.
`jax.random` cannot be reproduced in torch, so both packages map the same
numpy z where a seed would draw one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.sg3 import Generator as JaxGenerator
from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu.utils import fov_expansion as jfov
from stylegan3_editing_tpu.utils import gen_utils as jgen
from stylegan3_editing_tpu_torch.models.sg3 import Generator, SG3Config, load_jax_variables
from stylegan3_editing_tpu_torch.utils import gen_utils
from stylegan3_editing_tpu_torch.utils.fov_expansion import Expander
from test_torch_encoders import generator_variables

torch.set_num_threads(1)

TINY = dict(img_resolution=32, channel_base=512, channel_max=32, num_layers=4,
            num_critical=2, use_bf16=False)  # tests/test_editing.py's tiny_cfg
PATH_TOL = 1e-6
LATENT_RTOL = 1e-5
IMAGE_ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    cfg = JSG3Config(**TINY)
    variables = generator_variables(cfg, seed=100)
    G = Generator(SG3Config(**TINY), device="cpu")
    load_jax_variables(G, variables)
    return JaxGenerator(cfg), variables, G


def _close(got, ref, atol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    print(f"{what}: max abs err {err:.3g} (atol {atol:.3g})")
    assert got.shape == ref.shape and err <= atol, what


@pytest.mark.parametrize("mode", ["lerp", "slerp"])
def test_interpolation_helpers_match_jax(mode):
    """Random 512-wide W+ pairs, scalar and path weights, and the
    near-parallel fallback of slerp; then a 3-keyframe path."""
    rng = np.random.RandomState(101)
    a, b = rng.randn(2, 6, 512).astype(np.float32)
    fn, jfn = getattr(gen_utils, mode), getattr(jgen, mode)
    for t in (0.3, np.linspace(0, 1, 7)):
        _close(fn(a, b, t), jfn(a, b, t), PATH_TOL, f"{mode} t={t}")
    _close(fn(a, a, np.linspace(0, 1, 5)), jfn(a, a, np.linspace(0, 1, 5)), PATH_TOL,
           f"{mode} of parallel inputs")
    keys = rng.randn(3, 6, 512).astype(np.float32)
    path = gen_utils.interpolation_path(torch.from_numpy(keys), 4, mode=mode)
    assert path.shape == (9, 6, 512)
    _close(path, jgen.interpolation_path(jnp.asarray(keys), 4, mode=mode), PATH_TOL,
           f"{mode} path")
    assert torch.equal(path[-1], torch.from_numpy(keys[-1]))


def test_slerp_keeps_unit_norm():
    """tests/test_editing.py's case: the midpoint of two unit vectors."""
    s = gen_utils.slerp(np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0.5, 1]))
    assert abs(float(torch.linalg.norm(s[1])) - 1) < 1e-5
    _close(s[-1], [0, 1, 0], 1e-5, "slerp end point")


def test_get_w_from_seed_maps_the_seeded_z(pair):
    jmodel, variables, G = pair
    for seed in (3, torch.Generator().manual_seed(3)):
        with torch.no_grad():
            got = gen_utils.get_w_from_seed(G, seed, batch=2, truncation_psi=0.7)
        z = torch.randn((2, 512), generator=torch.Generator().manual_seed(3)).numpy()
        ref = np.asarray(jmodel.apply(variables, z, truncation_psi=0.7, method=jmodel.map))
        _close(got, ref, LATENT_RTOL * float(np.abs(ref).max()), "get_w_from_seed")


@pytest.mark.parametrize("shift", [0.0, 0.05], ids=["identity", "shifted"])
def test_expander_matches_jax(pair, shift):
    """tests/test_editing.py's expansion (left 4, top 2, right 3, bottom 0),
    with its identity landmarks transform and a shifted one: the canvas
    against the JAX `Expander`'s, and its centre against a plain synthesis."""
    jmodel, variables, G = pair
    ws = np.random.RandomState(102).randn(1, G.num_ws, 512).astype(np.float32)
    lm = np.eye(3, dtype=np.float32)
    lm[0, 2] = shift
    kw = dict(pixels_left=4, pixels_top=2, pixels_right=3, pixels_bottom=0)
    ref = jfov.Expander(jmodel, variables, 32).generate_expanded_image(jnp.asarray(ws), lm, **kw)
    got = Expander(G, 32).generate_expanded_image(torch.from_numpy(ws), lm, **kw)
    assert got.shape == (1, 2 + 32 + 0, 4 + 32 + 3, 3)
    _close(got, ref, IMAGE_ATOL, "expanded canvas")
    with torch.no_grad():
        plain = G.synthesize(torch.from_numpy(ws), transform=torch.from_numpy(lm))
    _close(got[:, 2:34, 4:36], plain, IMAGE_ATOL, "canvas centre vs plain synthesis")


def test_expander_fills_all_nine_slots(pair):
    """Every margin set: 9 views in one synthesis, each corner from its view."""
    _, _, G = pair
    ws = torch.from_numpy(np.random.RandomState(103).randn(2, G.num_ws, 512).astype(np.float32))
    exp = Expander(G, 32)
    with torch.no_grad():
        views = exp.views(ws, np.eye(3), 5, 6, 7, 8)
        canvas = exp.generate_expanded_image(ws, np.eye(3), 5, 6, 7, 8)
    assert len(views) == 9 and canvas.shape == (2, 7 + 32 + 8, 6 + 32 + 5, 3)
    assert torch.equal(canvas[:, :7, :6], views["top_left"][:, :7, :6])
    assert torch.equal(canvas[:, 39:, 38:], views["bottom_right"][:, 24:, 27:])


def test_interpolation_video_frames_match_jax(pair, tmp_path, monkeypatch):
    """Two seeds, 3 frames a segment, batches of 3: 4 frames padded to 6
    with the last frame, on the PNG branch of `generate_mp4` (no ffmpeg
    backend here), frame for frame against the JAX package's."""
    from PIL import Image

    pytest.importorskip("imageio")
    jmodel, variables, G = pair

    def z(seed):
        return np.random.RandomState(seed).randn(1, 512).astype(np.float32)

    monkeypatch.setattr(jgen, "get_w_from_seed", lambda m, v, s, truncation_psi: m.apply(
        v, z(s), truncation_psi=truncation_psi, method=m.map))
    monkeypatch.setattr(gen_utils, "get_w_from_seed", lambda m, s, truncation_psi: m.map(
        torch.from_numpy(z(s)), truncation_psi=truncation_psi))
    kw = dict(frames_per_segment=3, fps=10, truncation_psi=0.7, batch=3)
    n = gen_utils.interpolation_video(G, [5, 6], tmp_path / "port", **kw)
    jn = jgen.interpolation_video(jmodel, variables, [5, 6], str(tmp_path / "jax"), **kw)
    assert n == jn == 4
    assert not (tmp_path / "port.mp4").exists()
    names = sorted(p.name for p in (tmp_path / "port_frames").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax_frames").iterdir()) == [
        f"{i:06d}.png" for i in range(4)]
    for name in names:
        got, ref = (np.asarray(Image.open(tmp_path / f"{p}_frames" / name), np.int16)
                    for p in ("port", "jax"))
        assert got.shape == (32, 32, 3) and np.abs(got - ref).max() <= 1, name
