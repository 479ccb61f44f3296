"""Parity of the port's filtered-lrelu backward, AlexNet and LPIPS with the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function and
its PyTorch counterpart on the CPU. The backward's plain version
(`filtered_lrelu_bwd_ref`, what the CUDA kernel computes) is held against
`jax.vjp` of the JAX composition, and against the TPU backward kernel run in
interpret mode, at 2e-5 in fp32 (sums of up to 144 products taken in another
order); db, a sum over N·H·W of those, at 2e-5 of its largest entry. The
CUDA kernel itself is held against the plain version on the card in
`test_torch_kernels_gpu.py`.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.criteria.lpips import LPIPS as JaxLPIPS
from stylegan3_editing_tpu.criteria.lpips import \
    convert_lpips_linear_state as jax_convert_lpips
from stylegan3_editing_tpu.models.backbones.alexnet import AlexNetFeatures as JaxAlexNet
from stylegan3_editing_tpu.models.backbones.alexnet import \
    convert_alexnet_state as jax_convert_alexnet
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu.ops import image as jimage
from stylegan3_editing_tpu.ops.filtered_lrelu import filtered_lrelu as jax_filtered_lrelu
from stylegan3_editing_tpu.ops.pallas_flrelu import fused_filtered_lrelu_bwd
from stylegan3_editing_tpu_torch.criteria import LPIPS, convert_lpips_linear_state
from stylegan3_editing_tpu_torch.models.backbones import AlexNetFeatures, convert_alexnet_state
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from stylegan3_editing_tpu_torch.ops import flrelu_cuda
from stylegan3_editing_tpu_torch.ops.filtered_lrelu import (FusedFilteredLrelu, filtered_lrelu,
                                                            filtered_lrelu_bwd_ref,
                                                            filtered_lrelu_ref)
from stylegan3_editing_tpu_torch.ops.image import max_pool2d

torch.set_num_threads(1)

ATOL = RTOL = 2e-5
# The forward's four geometries (test_torch_ops.py) plus a u=4 radial layer
# with positive output growth.
GEOMETRIES = ["L0_36_1024", "L2_52_1024", "L12_1044_64", "L13_1024_64", "L4_84_1024"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _layer(name):
    layout = jcfg.build_synthesis_layout(jcfg.sg3_r_config(1024))
    return next(s for s in layout.layers if s.name == name)


def _layer_inputs(spec, seed=0, c=7):
    """x scaled so that some up-grid values pass the clamp of 256."""
    rng = np.random.RandomState(seed)
    hi = max(spec.in_size[1] // 16, 24)
    wi = max(spec.in_size[0] // 16, 24) + 3
    x = (rng.randn(2, hi, wi, c) * 150).astype(np.float32)
    b = (rng.randn(c) * 10).astype(np.float32)
    return x, b, rng


def _kw(s):
    return dict(fu=s.up_filter, fd=s.down_filter, up=s.up_factor, down=s.down_factor,
                padding=s.padding, clamp=s.conv_clamp)


def _assert_db(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL * np.abs(ref).max())


# ------------------------------------------------------ filtered-lrelu backward

@pytest.mark.parametrize("name", GEOMETRIES)
def test_bwd_ref_matches_jax_vjp_of_composition(name):
    s = _layer(name)
    x, b, rng = _layer_inputs(s)
    y, vjp = jax.vjp(lambda xc, bc: jax_filtered_lrelu(xc, b=bc, impl="xla", **_kw(s)),
                     jnp.asarray(x), jnp.asarray(b))
    dy = rng.randn(*y.shape).astype(np.float32)
    want_dx, want_db = (np.asarray(v) for v in vjp(jnp.asarray(dy)))
    dx = filtered_lrelu_bwd_ref(_t(dy), _t(x), s.up_filter, s.down_filter, _t(b),
                                s.up_factor, s.padding, clamp=s.conv_clamp)
    assert dx.shape == x.shape and dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=ATOL, rtol=RTOL)
    _assert_db(dx.sum((0, 1, 2)).numpy(), want_db)
    unclamped = filtered_lrelu_bwd_ref(_t(dy), _t(x), s.up_filter, s.down_filter, _t(b),
                                       s.up_factor, s.padding, clamp=None)
    assert not torch.allclose(unclamped, dx, atol=1e-3), "the clamp is not exercised"


def test_bwd_ref_matches_pallas_kernel_interpret():
    """L0 (radial fd, u=2) against the TPU backward kernel in interpret mode."""
    s = _layer("L0_36_1024")
    x, b, rng = _layer_inputs(s, seed=3, c=32)
    x = x[:1, :24, :24]
    y = jax_filtered_lrelu(jnp.asarray(x), b=jnp.asarray(b), impl="xla", **_kw(s))
    dy = rng.randn(*y.shape).astype(np.float32)
    want = np.asarray(fused_filtered_lrelu_bwd(
        jnp.asarray(dy), jnp.asarray(x), s.up_filter, s.down_filter, jnp.asarray(b),
        s.up_factor, s.down_factor, tuple(s.padding), gain=math.sqrt(2), slope=0.2,
        clamp=s.conv_clamp, c_block=32, interpret=True))
    dx = filtered_lrelu_bwd_ref(_t(dy), _t(x), s.up_filter, s.down_filter, _t(b),
                                s.up_factor, s.padding, clamp=s.conv_clamp)
    np.testing.assert_allclose(dx.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["L2_52_1024", "L13_1024_64"])
def test_cpu_autograd_equals_bwd_ref(name):
    """On the CPU `filtered_lrelu` takes autograd of the composition; its
    gradients equal the backward's plain version (dx, and db = Σ dx)."""
    s = _layer(name)
    x, b, rng = _layer_inputs(s, seed=5)
    xt, bt = _t(x).requires_grad_(True), _t(b).requires_grad_(True)
    y = filtered_lrelu(xt, b=bt, **_kw(s))
    dy = _t(rng.randn(*y.shape).astype(np.float32))
    gx, gb = torch.autograd.grad(y, (xt, bt), dy)
    dx = filtered_lrelu_bwd_ref(dy, _t(x), s.up_filter, s.down_filter, _t(b),
                                s.up_factor, s.padding, clamp=s.conv_clamp)
    np.testing.assert_allclose(gx.numpy(), dx.numpy(), atol=ATOL, rtol=RTOL)
    _assert_db(gb.numpy(), dx.sum((0, 1, 2)).numpy())


@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_function_matches_autograd_of_composition(monkeypatch, with_bias):
    """The autograd Function's wiring, on the CPU: its two kernel wrappers
    are replaced by their plain versions (the kernels need a card). Its
    gradients, a non-contiguous dy included, equal autograd of the
    composition, with one backward launch per backward pass."""
    s = _layer("L12_1044_64")
    calls = []

    def fwd(x, fu, fd, b, up, padding, gain, slope, clamp):
        return filtered_lrelu_ref(x, fu, fd, b, up, 2, padding, gain, slope, clamp)

    def bwd(dy, x, fu, fd, b, up, padding, gain, slope, clamp):
        assert dy.is_contiguous()
        calls.append(1)
        return filtered_lrelu_bwd_ref(dy, x, fu, fd, b, up, padding, gain, slope, clamp)

    monkeypatch.setattr(flrelu_cuda, "filtered_lrelu_cuda", fwd)
    monkeypatch.setattr(flrelu_cuda, "filtered_lrelu_bwd_cuda", bwd)
    x, b, rng = _layer_inputs(s, seed=6)
    xt = _t(x).requires_grad_(True)
    bt = _t(b).requires_grad_(True) if with_bias else None
    args = (s.up_filter, s.down_filter, s.up_factor, s.padding, math.sqrt(2), 0.2,
            s.conv_clamp)
    y = FusedFilteredLrelu.apply(xt, bt, *args)
    dy = _t(rng.randn(y.shape[0], y.shape[2], y.shape[1], y.shape[3]).astype(np.float32))
    dy = dy.transpose(1, 2)  # non-contiguous, as autograd may hand it over
    inputs = (xt, bt) if with_bias else (xt,)
    got = torch.autograd.grad(y, inputs, dy)
    assert len(calls) == 1
    ref = filtered_lrelu_ref(xt, s.up_filter, s.down_filter, bt, s.up_factor, 2, s.padding,
                             clamp=s.conv_clamp)
    want = torch.autograd.grad(ref, inputs, dy)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=ATOL, rtol=RTOL)
    if with_bias:
        _assert_db(got[1].numpy(), want[1].numpy())


def test_backward_padding_matches_reference_formula():
    """pp0 + pp1 sizes dy's ×2 up pass to the x grid plus the fu halo."""
    for s in [_layer(n) for n in GEOMETRIES]:
        tu, td = len(s.up_filter), s.down_filter.shape[0]
        (xw, xh), (yw, yh) = s.in_size, s.out_size
        pp0, pp1 = flrelu_cuda.backward_padding(xw, yw, s.up_factor, s.padding[0], tu, td)
        assert 2 * yw + pp0 + pp1 - (td - 1) == xw * s.up_factor + tu - s.up_factor


# ------------------------------------------------------------ AlexNet / LPIPS

@pytest.mark.parametrize("args", [(3, 2), (2, 2), (3, 1)])
def test_max_pool2d_matches_jax(args):
    x = np.random.RandomState(8).randn(2, 13, 11, 4).astype(np.float32)
    want = np.asarray(jimage.max_pool2d(jnp.asarray(x), *args))
    got = max_pool2d(_t(x), *args).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _torchvision_state(rng):
    shapes = {0: (64, 3, 11, 11), 3: (192, 64, 5, 5), 6: (384, 192, 3, 3),
              8: (256, 384, 3, 3), 10: (256, 256, 3, 3)}
    state = {}
    for i, shape in shapes.items():
        state[f"features.{i}.weight"] = rng.randn(*shape).astype(np.float32) * 0.05
        state[f"features.{i}.bias"] = rng.randn(shape[0]).astype(np.float32) * 0.05
    return state


def test_alexnet_features_match_jax():
    """Weights through each package's torchvision converter; features at
    1e-4 (fp32 convs of up to 3456 products)."""
    rng = np.random.RandomState(9)
    state = _torchvision_state(rng)
    x = rng.randn(2, 67, 64, 3).astype(np.float32)
    want = JaxAlexNet().apply(jax_convert_alexnet(state), jnp.asarray(x))
    net = AlexNetFeatures()
    load_jax_variables(net, convert_alexnet_state(state))
    got = net(_t(x))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_lpips_linear_converter_matches_jax():
    rng = np.random.RandomState(10)
    state = {f"{i}.1.weight": rng.rand(1, c, 1, 1).astype(np.float32)
             for i, c in enumerate((64, 192, 384, 256, 256))}
    want, got = jax_convert_lpips(state), convert_lpips_linear_state(state)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_lpips_alex_score_and_input_gradient_match_jax():
    """Score at 1e-5 relative, input gradient at 1e-4 of its largest entry
    (fp32 convs in another order)."""
    rng = np.random.RandomState(11)
    x = np.tanh(rng.randn(2, 64, 64, 3)).astype(np.float32)
    y = np.tanh(rng.randn(2, 64, 64, 3)).astype(np.float32)
    jl = JaxLPIPS(net_type="alex")
    variables = jax.jit(jl.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    for i, c in enumerate((64, 192, 384, 256, 256)):  # heads other than the mean
        variables["params"][f"lin{i}"] = rng.rand(1, 1, c, 1).astype(np.float32) / c
    want, want_g = jax.jit(jax.value_and_grad(
        lambda a: jl.apply(variables, a, jnp.asarray(y))))(jnp.asarray(x))
    assert np.isfinite(np.asarray(want_g)).all(), "JAX gradient not finite: zero-norm feature"
    lp = LPIPS("alex", device="cpu")
    load_jax_variables(lp, variables)
    xt = _t(x).requires_grad_(True)
    score = lp(xt, _t(y))
    (g,) = torch.autograd.grad(score, xt)
    np.testing.assert_allclose(score.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want_g)).max())


def test_lpips_other_trunks_are_not_ported():
    """vgg and squeeze are ported (5 and 7 heads, each 1/C); any other trunk
    still raises."""
    for net, heads in (("vgg", (64, 128, 256, 512, 512)),
                       ("squeeze", (64, 128, 256, 384, 384, 512, 512))):
        lp = LPIPS(net, device="cpu")
        assert [tuple(getattr(lp, f"lin{i}").shape) for i in range(len(heads))] == [
            (1, 1, c, 1) for c in heads] and not hasattr(lp, f"lin{len(heads)}")
        assert all(torch.all(getattr(lp, f"lin{i}") == 1.0 / c) for i, c in enumerate(heads))
    with pytest.raises(NotImplementedError, match="resnet"):
        LPIPS("resnet", device="cpu")
