"""Parity of the port's evaluation criteria with the JAX package, on the CPU:
`max_pool2d` with ``ceil_mode``, SqueezeNet-1.1 and its converter, the VGG
converters, LPIPS on its three trunks, SSIM and MS-SSIM.

Weights: torchvision-named state dicts are drawn from a numpy seed and go
through both packages' converters (leaf for leaf equal), or a JAX tree is
shaped by `jax.eval_shape` of the flax init and filled from a seed
(`test_torch_encoders.seeded_variables`); `load_jax_variables` copies it
into the port. Inputs are seeded numpy arrays.

Tolerances:
- max pooling: exact (a max picks one input);
- SqueezeNet's taps (9 convs deep): 1e-5 of max |ref| per tap (fp32 convs
  summed in another order in XLA and in PyTorch);
- LPIPS on each trunk: 1e-5 relative (a mean of unit-normalised squared
  feature differences, up to 13 convs deep);
- SSIM and MS-SSIM: 1e-5 relative per value, NaN where the JAX value is NaN
  (a negative contrast term to a fractional power without normalisation).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.criteria import lpips as jlpips
from stylegan3_editing_tpu.criteria import ms_ssim as jms_ssim
from stylegan3_editing_tpu.models.backbones import squeezenet as jsqueeze
from stylegan3_editing_tpu.models.backbones import vgg as jvgg
from stylegan3_editing_tpu.ops import image as jimage
from stylegan3_editing_tpu_torch.criteria import LPIPS, msssim, ssim
from stylegan3_editing_tpu_torch.models.backbones import (SqueezeNetFeatures,
                                                          VGG16Features, VGG19Features,
                                                          convert_squeezenet_state,
                                                          convert_vgg16_state,
                                                          convert_vgg19_state)
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from stylegan3_editing_tpu_torch.ops.image import max_pool2d

from test_torch_encoders import seeded_variables

torch.set_num_threads(1)

FEATURE_TOL = 1e-5
LPIPS_RTOL = 1e-5
SSIM_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def _same_tree(got, want):
    fg, fw = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and np.array_equal(fg[k], fw[k]), k


# ----------------------------------------------------------------- max pool

@pytest.mark.parametrize("size", [(13, 13), (14, 11), (7, 9)])
@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("ceil_mode", [False, True])
def test_max_pool2d_ceil_mode_matches_jax(size, padding, ceil_mode):
    x = np.random.RandomState(sum(size) + padding).randn(2, *size, 5).astype(np.float32)
    want = np.asarray(jimage.max_pool2d(jnp.asarray(x), 3, 2, padding=padding,
                                        ceil_mode=ceil_mode))
    got = max_pool2d(_t(x), 3, 2, padding=padding, ceil_mode=ceil_mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- SqueezeNet

SQUEEZE_FIRES = ((16, 64), (16, 64), (32, 128), (32, 128), (48, 192), (48, 192), (64, 256),
                 (64, 256))  # (squeeze, expand per branch) of fire3 ... fire12


def squeezenet_state(seed=0):
    """A torchvision ``squeezenet1_1().features`` state dict, numpy only."""
    rng = np.random.default_rng(seed)
    state = {"features.0.weight": rng.standard_normal((64, 3, 3, 3), np.float32) / math.sqrt(27),
             "features.0.bias": 0.1 * rng.standard_normal(64, np.float32)}
    cin = 64
    for idx, (sq, ex) in zip((3, 4, 6, 7, 9, 10, 11, 12), SQUEEZE_FIRES):
        for branch, (cout, c_in, k) in (("squeeze", (sq, cin, 1)), ("expand1x1", (ex, sq, 1)),
                                        ("expand3x3", (ex, sq, 3))):
            state[f"features.{idx}.{branch}.weight"] = (
                rng.standard_normal((cout, c_in, k, k), np.float32) / math.sqrt(c_in * k * k))
            state[f"features.{idx}.{branch}.bias"] = 0.1 * rng.standard_normal(cout, np.float32)
        cin = 2 * ex
    return state


def test_squeezenet_taps_and_converter_match_jax():
    state = squeezenet_state()
    got, want = convert_squeezenet_state(state), jsqueeze.convert_squeezenet_state(state)
    _same_tree(got, want)
    x = np.random.RandomState(1).randn(2, 67, 67, 3).astype(np.float32)
    ref = jsqueeze.SqueezeNetFeatures().apply(want, jnp.asarray(x))
    net = SqueezeNetFeatures()
    load_jax_variables(net, got)
    with torch.no_grad():
        feats = net(_t(x))
    assert len(feats) == len(ref) == 7
    for i, (f, r) in enumerate(zip(feats, ref)):
        r = np.asarray(r)
        assert f.shape == r.shape and r.shape[-1] == jsqueeze.N_CHANNELS[i]
        np.testing.assert_allclose(f.numpy(), r, rtol=0, atol=FEATURE_TOL * np.abs(r).max())


# --------------------------------------------------------------------- VGG

@pytest.mark.parametrize("depth", [16, 19])
def test_vgg_converters_match_jax(depth):
    """Every conv of a torchvision ``vggN().features`` state (conv, ReLU and
    pool entries) lands under the JAX converter's name, equal; the tree
    fills the port's stack name for name."""
    stages = jvgg._STAGES if depth == 16 else jvgg._STAGES19
    rng = np.random.default_rng(depth)
    state, idx, cin = {}, 0, 3
    for stage_i, widths in enumerate(stages):
        idx += stage_i > 0
        for w in widths:
            state[f"features.{idx}.weight"] = rng.standard_normal((w, cin, 3, 3), np.float32)
            state[f"features.{idx}.bias"] = rng.standard_normal(w, np.float32)
            idx, cin = idx + 2, w
    port, jax_conv = ((convert_vgg16_state, jvgg.convert_vgg16_state) if depth == 16
                      else (convert_vgg19_state, jvgg.convert_vgg19_state))
    got = port(state)
    _same_tree(got, jax_conv(state))
    net = VGG16Features() if depth == 16 else VGG19Features()
    load_jax_variables(net, got)
    last = sum(map(len, stages)) - 1
    np.testing.assert_array_equal(getattr(net, f"conv{last}").kernel.detach().numpy(),
                                  state[f"features.{idx - 2}.weight"].transpose(2, 3, 1, 0))


# ------------------------------------------------------------------- LPIPS

def _lpips_variables(net_type, x, seed):
    shapes = jax.eval_shape(jlpips.LPIPS(net_type=net_type).init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(x))
    heads = {k: v for k, v in shapes["params"].items() if k.startswith("lin")}
    trunk = seeded_variables({"params": {"net": shapes["params"]["net"]}}, seed)
    rng = np.random.RandomState(seed)
    params = dict(trunk["params"])
    for k, v in heads.items():  # non-negative heads other than the mean
        params[k] = (rng.rand(*v.shape) / v.shape[2]).astype(np.float32)
    return {"params": params}


@pytest.mark.parametrize("net_type", ["alex", "vgg", "squeeze"])
def test_lpips_matches_jax(net_type):
    rng = np.random.RandomState(5)
    x = np.tanh(rng.randn(2, 64, 64, 3)).astype(np.float32)
    y = np.tanh(x + 0.5 * rng.randn(2, 64, 64, 3)).astype(np.float32)
    variables = _lpips_variables(net_type, x, seed=7)
    want = float(jlpips.LPIPS(net_type=net_type).apply(variables, jnp.asarray(x),
                                                       jnp.asarray(y)))
    lp = LPIPS(net_type, device="cpu")
    load_jax_variables(lp, variables)
    with torch.no_grad():
        got = lp(_t(x), _t(y)).item()
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)


# -------------------------------------------------------------- SSIM/MS-SSIM

def _pair(kind, shape, seed):
    """Images in [-1, 1], [0, 1] or 0–255, the second a noisy copy."""
    rng = np.random.RandomState(seed)
    a = np.tanh(rng.randn(*shape)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*shape), -1, 1).astype(np.float32)
    if kind == "unit":
        a, b = (a + 1) / 2, (b + 1) / 2
    elif kind == "byte":
        a, b = (a + 1) * 127.5, (b + 1) * 127.5
    return a, b


@pytest.mark.parametrize("kind", ["signed", "unit", "byte"])
@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(kind, size_average):
    a, b = _pair(kind, (3, 24, 20, 3), seed=2)
    for window in (11, 7):
        want_s, want_cs = jms_ssim.ssim(jnp.asarray(a), jnp.asarray(b), window_size=window,
                                        size_average=size_average, full=True)
        got_s, got_cs = ssim(_t(a), _t(b), window_size=window, size_average=size_average,
                             full=True)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=SSIM_RTOL)
        np.testing.assert_allclose(got_cs.numpy(), np.asarray(want_cs), rtol=SSIM_RTOL)
    small = ssim(_t(a[:, :8, :9]), _t(b[:, :8, :9]))  # the window shrinks to 8
    np.testing.assert_allclose(small.item(), float(jms_ssim.ssim(
        jnp.asarray(a[:, :8, :9]), jnp.asarray(b[:, :8, :9]))), rtol=SSIM_RTOL)


@pytest.mark.parametrize("kind", ["signed", "unit", "byte"])
@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("normalize", [None, "relu", "simple", True])
def test_msssim_matches_jax(kind, size_average, normalize):
    a, b = _pair(kind, (2, 64, 48, 3), seed=3)
    for val_range in (None, 2.0):
        want = np.asarray(jms_ssim.msssim(jnp.asarray(a), jnp.asarray(b),
                                          size_average=size_average, val_range=val_range,
                                          normalize=normalize))
        got = msssim(_t(a), _t(b), size_average=size_average, val_range=val_range,
                     normalize=normalize).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=SSIM_RTOL)


@pytest.mark.parametrize("normalize", [None, "relu", "simple"])
def test_msssim_uncorrelated_images_nan_as_jax(normalize):
    """Independent images: a negative contrast term makes the plain form NaN
    in both packages; relu and simple stay finite and agree."""
    rng = np.random.RandomState(9)
    a, b = (np.tanh(rng.randn(2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jms_ssim.msssim(jnp.asarray(a), jnp.asarray(b), size_average=False,
                                      normalize=normalize))
    got = msssim(_t(a), _t(b), size_average=False, normalize=normalize).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if normalize is None:
        assert np.isnan(want).any()
    else:
        assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=SSIM_RTOL)
