"""Parity of the port's ops (stylegan3_editing_tpu_torch.ops) with the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and its PyTorch counterpart on the CPU. fp32 tolerances are 2e-5 (sums of up
to 144 products taken in another order); the modulated conv is held at 1e-5.
The CUDA kernel is held against the plain version on the card in
`test_torch_kernels_gpu.py`.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu.ops.pallas_flrelu import fused_filtered_lrelu
from stylegan3_editing_tpu_torch.models.sg3 import config as tcfg

# The ops packages re-export functions under their modules' names.
jbias_act, jfd, jflrelu, jmodconv, jup = (
    importlib.import_module(f"stylegan3_editing_tpu.ops.{m}") for m in
    ("bias_act", "filter_design", "filtered_lrelu", "modulated_conv", "upfirdn2d"))
tbias_act, tfd, tflrelu, tmodconv, tup = (
    importlib.import_module(f"stylegan3_editing_tpu_torch.ops.{m}") for m in
    ("bias_act", "filter_design", "filtered_lrelu", "modulated_conv", "upfirdn2d"))

torch.set_num_threads(1)

ATOL = RTOL = 2e-5
# One u=2 positive-pad, one u=4 crop, one separable-down, one separable crop.
GEOMETRIES = ["L0_36_1024", "L2_52_1024", "L12_1044_64", "L13_1024_64"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _layer(name):
    layout = jcfg.build_synthesis_layout(jcfg.sg3_r_config(1024))
    return next(s for s in layout.layers if s.name == name)


def _layer_inputs(spec, seed=0):
    rng = np.random.RandomState(seed)
    hi = max(spec.in_size[1] // 16, 24)
    wi = max(spec.in_size[0] // 16, 24)
    c = min(spec.out_channels, 40)
    x = rng.randn(2, hi, wi, c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    return x, b


# ------------------------------------------------------------ host-side math

@pytest.mark.parametrize("preset", ["r", "t"])
def test_layout_and_filters_match_jax(preset):
    """Layout, filter taps and Fourier buffers equal the JAX package's exactly."""
    jl = jcfg.build_synthesis_layout(getattr(jcfg, f"sg3_{preset}_config")(1024))
    tl = tcfg.build_synthesis_layout(getattr(tcfg, f"sg3_{preset}_config")(1024))
    np.testing.assert_array_equal(tl.input.freqs, jl.input.freqs)
    np.testing.assert_array_equal(tl.input.phases, jl.input.phases)
    assert (tl.input.size, tl.input.channels) == (jl.input.size, jl.input.channels)
    assert len(tl.layers) == len(jl.layers)
    for a, b in zip(tl.layers, jl.layers):
        for field in ("name", "use_bf16", "in_channels", "out_channels", "in_size",
                      "out_size", "up_factor", "down_factor", "up_taps", "down_taps",
                      "down_radial", "padding", "conv_kernel", "is_torgb"):
            assert getattr(a, field) == getattr(b, field), (a.name, field)
        for f in ("up_filter", "down_filter"):
            fa, fb = getattr(a, f), getattr(b, f)
            assert (fa is None) == (fb is None)
            if fa is not None:
                np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("args", [
    dict(f=None), dict(f=[1, 3, 3, 1]), dict(f=list(range(1, 9))),
    dict(f=[1, 2, 1], gain=4, separable=True), dict(f=[1, 3, 3, 1], flip_filter=True),
])
def test_setup_filter_matches_jax(args):
    np.testing.assert_array_equal(tfd.setup_filter(**args), jfd.setup_filter(**args))


# ------------------------------------------------------------------ bias_act

@pytest.mark.parametrize("act", sorted(jbias_act.activation_funcs))
def test_bias_act_matches_jax(act):
    assert set(tbias_act.activation_funcs) == set(jbias_act.activation_funcs)
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 5, 6, 7) * 3).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    for kw in (dict(), dict(clamp=1.5), dict(alpha=0.3, gain=0.7)):
        ref = np.asarray(jbias_act.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, **kw))
        got = tbias_act.bias_act(_t(x), _t(b), act=act, **kw).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL, err_msg=str(kw))


# ----------------------------------------------------------------- upfirdn2d

@pytest.mark.parametrize("case", [
    dict(f="sep12", up=2, padding=(11, 10, 11, 10)),
    dict(f="sep24", up=4, padding=(-2, -5, -2, -5)),
    dict(f="sep12", down=2, padding=(-3, -4, -3, 4)),
    dict(f="rad12", down=2, padding=(1, 2, 3, 0), flip_filter=True),
    dict(f="rad12", up=(2, 1), down=(1, 2), padding=(5, -1, 0, 2), gain=3.0),
    dict(f=None, padding=(-1, 2, 1, -2)),
])
def test_upfirdn2d_matches_jax(case):
    rng = np.random.RandomState(2)
    filters = {
        None: None,
        "sep12": tfd.design_lowpass_filter(12, 2.0, 4.0, 32),
        "sep24": tfd.design_lowpass_filter(24, 2.0, 4.0, 64),
        "rad12": tfd.design_lowpass_filter(12, 2.0, 4.0, 32, radial=True),
    }
    case = dict(case)
    f = filters[case.pop("f")]
    x = rng.randn(2, 19, 23, 5).astype(np.float32)
    ref = np.asarray(jup.upfirdn2d(jnp.asarray(x), f, **case))
    got = tup.upfirdn2d(_t(x), f, **case).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fn", ["filter2d", "upsample2d", "downsample2d"])
def test_resample_helpers_match_jax(fn):
    rng = np.random.RandomState(3)
    x = rng.randn(1, 16, 12, 3).astype(np.float32)
    f = tfd.setup_filter([1, 3, 3, 1])
    ref = np.asarray(getattr(jup, fn)(jnp.asarray(x), f, padding=(1, 0, 2, 1)))
    got = getattr(tup, fn)(_t(x), f, padding=(1, 0, 2, 1)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------ filtered lrelu

@pytest.mark.parametrize("name", GEOMETRIES)
def test_filtered_lrelu_plain_matches_jax_composition(name):
    s = _layer(name)
    x, b = _layer_inputs(s)
    kw = dict(fu=s.up_filter, fd=s.down_filter, up=s.up_factor, down=s.down_factor,
              padding=s.padding, clamp=s.conv_clamp)
    ref = np.asarray(jflrelu.filtered_lrelu(jnp.asarray(x), b=jnp.asarray(b),
                                            impl="xla", **kw))
    got = tflrelu.filtered_lrelu(_t(x), b=_t(b), **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_filtered_lrelu_plain_matches_pallas_kernel_interpret():
    """L2 (u=4, crop) against the TPU kernel run in interpret mode."""
    s = _layer("L2_52_1024")
    x, b = _layer_inputs(s, seed=4)
    ref = np.asarray(fused_filtered_lrelu(
        jnp.asarray(x), s.up_filter, s.down_filter, jnp.asarray(b), s.up_factor,
        s.down_factor, tuple(s.padding), gain=math.sqrt(2), slope=0.2,
        clamp=s.conv_clamp, c_block=32, interpret=True))
    got = tflrelu.filtered_lrelu(
        _t(x), s.up_filter, s.down_filter, _t(b), s.up_factor, s.down_factor,
        s.padding, clamp=s.conv_clamp).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_filtered_lrelu_torgb_geometry_matches_jax():
    """The filterless ToRGB configuration (up = down = 1, gain 1, slope 1)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 8, 8, 3) * 300).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    kw = dict(gain=1.0, slope=1.0, clamp=256.0)
    ref = np.asarray(jflrelu.filtered_lrelu(jnp.asarray(x), b=jnp.asarray(b), **kw))
    got = tflrelu.filtered_lrelu(_t(x), b=_t(b), **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------- modulated conv

@pytest.mark.parametrize("kernel", [1, 3])
@pytest.mark.parametrize("demodulate", [True, False])
def test_modulated_conv2d_matches_jax(kernel, demodulate):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 9, 10, 6).astype(np.float32)
    w = rng.randn(kernel, kernel, 6, 5).astype(np.float32)
    s = (rng.randn(2, 6) + 1).astype(np.float32)
    gain = np.float32(0.8)
    pad = kernel - 1
    ref = np.asarray(jmodconv.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), demodulate=demodulate,
        padding=pad, input_gain=jnp.asarray(gain)))
    got = tmodconv.modulated_conv2d(
        _t(x), _t(w), _t(s), demodulate=demodulate, padding=pad,
        input_gain=torch.tensor(gain)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
