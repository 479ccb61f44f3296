"""The hand-written CUDA kernels of the port against their plain versions, on the card.

The filtered-lrelu forward kernel against `filtered_lrelu_ref` (its down pass
on the tensor cores for bf16 radial layers, on the CUDA cores otherwise), the backward
kernel against `filtered_lrelu_bwd_ref`, and autograd through both; the
banded-FIR probe's tap-chain kernel against `fir_taps_ref` and its
tensor-core kernel against `fir_banded_ref`.

These tests need a CUDA card and skip elsewhere: a CUDA kernel has no CPU
mode. They import nothing of JAX, so they run where only PyTorch is
installed (`tests/conftest.py` imports JAX; skip it there):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import copy

import numpy as np
import pytest
import torch

from chip_smoke import reference_state
from stylegan3_editing_tpu_torch.models.backbones.common import Conv2d
from stylegan3_editing_tpu_torch.models.sg3 import (Generator, build_synthesis_layout,
                                                    sg3_r_config, sg3_t_config)
from stylegan3_editing_tpu_torch.ops import filtered_lrelu, filtered_lrelu_bwd_ref
from stylegan3_editing_tpu_torch.ops.modulated_conv import modulated_conv2d
from stylegan3_editing_tpu_torch.ops import cuda_build, fir_cuda, flrelu_cuda
from stylegan3_editing_tpu_torch.ops.banded_fir import (banded, fir_banded, fir_banded_ref,
                                                        fir_taps, fir_taps_ref, hann_taps)

# u=2 pad, u=4 crop, separable, separable crop, and radial layers whose bf16
# down pass runs on the tensor cores: u=2 (L8, L11) and u=4 (L10).
GEOMETRIES = ["L0_36_1024", "L2_52_1024", "L12_1044_64", "L13_1024_64", "L8_276_406",
              "L10_1044_161", "L11_1044_102"]
# The backward also on SG3-T's separable u=4 layer (its own tile shape) and crop.
BWD_GEOMETRIES = GEOMETRIES + ["T:L2_52_512", "T:L13_1024_32"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer(name):
    """An SG3-R 1024 layer by name, or an SG3-T one as ``"T:<name>"``."""
    preset, _, name = name.rpartition(":")
    layout = build_synthesis_layout((sg3_t_config if preset == "T" else sg3_r_config)(1024))
    return next(s for s in layout.layers if s.name == name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flrelu_kernel_matches_plain(cuda_device, name, dtype):
    """fp32: atol = rtol = 1e-4 (sum order, cuDNN). bf16: one bf16 rounding
    of the output (rtol 2^-8, atol 1e-3) against the plain version in fp32 on
    the upcast input. Reduced spatial size, 2 images, ragged channel count."""
    s = _layer(name)
    rng = np.random.RandomState(7)
    hi = max(s.in_size[1] // 8, 40)
    c = min(s.out_channels, 45)
    x = torch.from_numpy(rng.randn(2, hi, hi + 5, c).astype(np.float32))
    b = torch.from_numpy(rng.randn(c).astype(np.float32))
    xd = x.to(cuda_device, getattr(torch, dtype))
    bd = b.to(cuda_device, xd.dtype)
    kw = dict(fu=s.up_filter, fd=s.down_filter, up=s.up_factor, down=s.down_factor,
              padding=s.padding, clamp=s.conv_clamp)
    before = flrelu_cuda.launches["filtered_lrelu_fwd"]
    with torch.no_grad():
        got = filtered_lrelu(xd, b=bd, **kw)
        assert flrelu_cuda.launches["filtered_lrelu_fwd"] == before + 1
        ref = filtered_lrelu(xd.float(), b=bd.float(), impl="ref", **kw)
    torch.cuda.synchronize()
    assert got.dtype == xd.dtype and got.shape == ref.shape
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (1e-3, 2 ** -8)
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_flrelu_forward_sass_holds_bf16_tensor_core_instructions(cuda_device):
    """The bf16 radial instantiations' down pass is m16n8k16 bf16 mma.sync."""
    flrelu_cuda.build()
    counts = cuda_build.sass_mma_counts("filtered_lrelu_fwd")
    if counts is None:
        pytest.skip("cuobjdump not found")
    assert counts["HMMA.16816.F32.BF16"] > 0, counts


@pytest.mark.gpu
def test_flrelu_backward_sass_holds_bf16_tensor_core_instructions(cuda_device):
    """The bf16 radial instantiations' dy up pass is m16n8k16 bf16 mma.sync."""
    flrelu_cuda.build()
    counts = cuda_build.sass_mma_counts("filtered_lrelu_bwd")
    if counts is None:
        pytest.skip("cuobjdump not found")
    assert counts["HMMA.16816.F32.BF16"] > 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["modulated_conv2d_3x3", "alexnet_Conv2d",
                                "modulated_conv2d_up2"])
def test_convs_are_full_fp32_under_pytorchs_tf32_default(cuda_device, op):
    """With PyTorch's default (cuDNN may use TF32), the port's fp32 convs on
    the card, and their gradients (x and the weights; the styles of the
    modulated conv; the bias of `Conv2d`), agree with the same op in float64
    on the CPU to 1e-5 of max |ref| each: 576 to 2048 products per output,
    so TF32's 2^-11 operands would miss it by one to two orders. The
    backward runs inside ``backward()``, after the forward call has
    returned. ``modulated_conv2d_up2`` is the StyleGAN2 up-conv, a transposed
    conv (`device.conv_transpose2d`). The fixture's setting comes back after
    the test."""
    rng = np.random.RandomState(13)
    x, g = rng.randn(2, 32, 32, 64), rng.randn(2, 32, 32, 64)
    if op.startswith("modulated_conv2d"):
        w, s = rng.randn(3, 3, 64, 64), rng.randn(2, 64)
        up = 2 if op.endswith("up2") else 1
        if up == 2:
            g = rng.randn(2, 65, 65, 64)

        def run(device, dtype):
            leaves = [torch.from_numpy(a).to(device, dtype).requires_grad_() for a in (x, w, s)]
            out = modulated_conv2d(*leaves, padding=up, up=up)
            (out * torch.from_numpy(g).to(device, dtype)).sum().backward()
            return [out] + [t.grad for t in leaves]
    else:
        conv = Conv2d(64, 64, 3, padding=1, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            conv.bias.copy_(torch.from_numpy(rng.randn(64)))

        def run(device, dtype):
            # A copy each: `Module.to` would convert the grads of an earlier run in place.
            c = copy.deepcopy(conv).to(device, dtype)
            xd = torch.from_numpy(x).to(device, dtype).requires_grad_()
            out = c(xd)
            (out * torch.from_numpy(g).to(device, dtype)).sum().backward()
            return [out, xd.grad, c.kernel.grad, c.bias.grad]
    ref = run("cpu", torch.float64)
    cudnn = torch.backends.cudnn
    fixture_setting = cudnn.allow_tf32
    cudnn.allow_tf32 = True  # PyTorch's default
    try:
        got = run(cuda_device, torch.float32)
        torch.cuda.synchronize()
        still_allowed = cudnn.allow_tf32
    finally:
        cudnn.allow_tf32 = fixture_setting
    assert still_allowed, "the conv did not restore the caller's TF32 setting"
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == torch.float32 and a.shape == r.shape, i
        err = float((a.detach().double().cpu() - r.detach()).abs().max())
        top = float(r.detach().abs().max())
        assert err <= 1e-5 * top, (i, err, top)


@pytest.mark.gpu
def test_flrelu_kernel_raises_instead_of_falling_back(cuda_device):
    s = _layer("L0_36_1024")
    x = torch.zeros((1, 36, 36, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        flrelu_cuda.filtered_lrelu_cuda(x, s.up_filter, s.down_filter, None,
                                        s.up_factor, s.padding, 2 ** 0.5, 0.2, 256.0)
    x = torch.zeros((1, 36, 8, 36), device=cuda_device).transpose(2, 3)
    with pytest.raises(ValueError):
        flrelu_cuda.filtered_lrelu_cuda(x, s.up_filter, s.down_filter, None,
                                        s.up_factor, s.padding, 2 ** 0.5, 0.2, 256.0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", BWD_GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flrelu_bwd_kernel_matches_plain(cuda_device, name, dtype):
    """dx against `filtered_lrelu_bwd_ref` in fp32 on the upcast inputs.
    fp32: atol = rtol = 1e-4 (sum order, cuDNN); bf16: one bf16 rounding of
    dx (rtol 2^-8, atol 1e-3). x is scaled so that the clamp of 256 bites.
    Reduced spatial size, 2 images, ragged channel count."""
    s = _layer(name)
    rng = np.random.RandomState(8)
    hi = max(s.in_size[1] // 8, 40)
    c = min(s.out_channels, 45)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.randn(2, hi, hi + 5, c).astype(np.float32) * 150).to(cuda_device, dt)
    b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda_device, dt)
    out_h = flrelu_cuda.output_size(hi, s.up_factor, s.padding[2], s.padding[3],
                                    len(s.up_filter), s.down_filter.shape[0])
    out_w = flrelu_cuda.output_size(hi + 5, s.up_factor, s.padding[0], s.padding[1],
                                    len(s.up_filter), s.down_filter.shape[0])
    dy = torch.from_numpy(rng.randn(2, out_h, out_w, c).astype(np.float32)).to(cuda_device, dt)
    args = (s.up_filter, s.down_filter, b, s.up_factor, s.padding, 2 ** 0.5, 0.2, s.conv_clamp)
    before = flrelu_cuda.launches["filtered_lrelu_bwd"]
    got = flrelu_cuda.filtered_lrelu_bwd_cuda(dy, x, *args)
    assert flrelu_cuda.launches["filtered_lrelu_bwd"] == before + 1
    ref = filtered_lrelu_bwd_ref(dy.float(), x.float(), s.up_filter, s.down_filter, b.float(),
                                 s.up_factor, s.padding, clamp=s.conv_clamp)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == x.shape
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (1e-3, 2 ** -8)
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grown_decoder_layer_through_both_kernels(cuda_device, dtype):
    """SetGAN's superres decoder (`train_setgan_superres.sh`: SG3-T 256 grown
    to 512 with 4 head layers) gives the kernels shapes no other path does:
    L8 takes 276² at up 4 to a 532² grid with 55 channels. Both kernels at full size,
    batch 2, against the plain versions at `test_flrelu_kernel_matches_plain`'s
    and `test_flrelu_bwd_kernel_matches_plain`'s tolerances."""
    from stylegan3_editing_tpu_torch.models.sg3.superres import superres_config

    cfg = superres_config(sg3_t_config(256, channel_base=16384, channel_max=256, num_layers=7),
                          512, 4)
    s = next(spec for spec in build_synthesis_layout(cfg).layers if spec.name == "L8_532_55")
    assert s.up_factor == 4 and s.out_channels == 55 and s.in_size == (276, 276)
    rng = np.random.RandomState(18)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.randn(2, 276, 276, 55).astype(np.float32) * 60).to(cuda_device, dt)
    b = torch.from_numpy(rng.randn(55).astype(np.float32)).to(cuda_device, dt)
    kw = dict(fu=s.up_filter, fd=s.down_filter, up=s.up_factor, down=s.down_factor,
              padding=s.padding, clamp=s.conv_clamp)
    with torch.no_grad():
        got = filtered_lrelu(x, b=b, **kw)
        ref = filtered_lrelu(x.float(), b=b.float(), impl="ref", **kw)
    assert got.shape == ref.shape and got.shape[1] > 500
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (1e-3, 2 ** -8)
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)
    dy = torch.from_numpy(rng.randn(*got.shape).astype(np.float32)).to(cuda_device, dt)
    dx = flrelu_cuda.filtered_lrelu_bwd_cuda(dy, x, s.up_filter, s.down_filter, b, s.up_factor,
                                             s.padding, 2 ** 0.5, 0.2, s.conv_clamp)
    dx_ref = filtered_lrelu_bwd_ref(dy.float(), x.float(), s.up_filter, s.down_filter, b.float(),
                                    s.up_factor, s.padding, clamp=s.conv_clamp)
    torch.cuda.synchronize()
    assert dx.dtype == dt
    torch.testing.assert_close(dx.float(), dx_ref, atol=atol, rtol=rtol)


def _odd_view(a, device, dtype):
    """``a`` on the card as a contiguous tensor that starts one element past
    an aligned address, so no pixel's slice lies on a 16-byte boundary by
    construction."""
    flat = torch.zeros(a.size + 1, device=device, dtype=dtype)
    flat[1:] = torch.from_numpy(a.ravel()).to(device, dtype)
    return flat[1:].view(a.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["L10_1044_161", "L11_1044_102", "L12_1044_64"])
@pytest.mark.parametrize("c", [5, 6, 7])
def test_flrelu_bwd_kernel_ragged_channels_odd_alignment(cuda_device, name, c):
    """bf16, C ≡ 1, 2, 3 (mod 4), x and dy one element off alignment: the
    wide loads take their chunks and shifts (element loads at the tensors'
    ends), and dx's stores keep to its slices. Within one bf16 rounding of
    `filtered_lrelu_bwd_ref`."""
    s = _layer(name)
    rng = np.random.RandomState(10 + c)
    hi = 40
    x = _odd_view(rng.randn(2, hi, hi + 3, c).astype(np.float32) * 150, cuda_device,
                  torch.bfloat16)
    b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda_device)
    out_h = flrelu_cuda.output_size(hi, s.up_factor, s.padding[2], s.padding[3],
                                    len(s.up_filter), s.down_filter.shape[0])
    out_w = flrelu_cuda.output_size(hi + 3, s.up_factor, s.padding[0], s.padding[1],
                                    len(s.up_filter), s.down_filter.shape[0])
    dy = _odd_view(rng.randn(2, out_h, out_w, c).astype(np.float32), cuda_device, torch.bfloat16)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2 and dy.data_ptr() % 16 == 2
    got = flrelu_cuda.filtered_lrelu_bwd_cuda(dy, x, s.up_filter, s.down_filter, b, s.up_factor,
                                              s.padding, 2 ** 0.5, 0.2, s.conv_clamp)
    ref = filtered_lrelu_bwd_ref(dy.float(), x.float(), s.up_filter, s.down_filter, b,
                                 s.up_factor, s.padding, clamp=s.conv_clamp)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref, atol=1e-3, rtol=2 ** -8)


@pytest.mark.gpu
def test_loss_backward_launches_one_bwd_kernel_per_layer(cuda_device):
    """One forward and one `loss.backward()` of a slim SG3-R on the card:
    each filtered layer launches the forward kernel once and the backward
    kernel once, and the gradients equal those through impl='ref' (fp32, atol
    1e-4 of each tensor's largest |grad|)."""
    cfg = sg3_r_config(64, channel_base=2048, channel_max=64, num_layers=6, use_bf16=False)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
    G = Generator(cfg, device=cuda_device)
    z = torch.randn((2, cfg.z_dim), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    grads = {}
    for impl in ("auto", "ref"):
        G.zero_grad()
        flrelu_cuda.reset_launches()
        G(z, impl=impl).square().mean().backward()
        torch.cuda.synchronize()
        want = {"auto": n_layers, "ref": 0}[impl]
        assert flrelu_cuda.launches == {"filtered_lrelu_fwd": want, "filtered_lrelu_bwd": want,
                                        "fir_taps": 0, "fir_banded": 0}
        grads[impl] = {k: p.grad.clone() for k, p in G.synthesis.named_parameters()
                       if p.grad is not None}
    assert grads["auto"].keys() == grads["ref"].keys() and grads["auto"]
    for k, g in grads["ref"].items():
        torch.testing.assert_close(grads["auto"][k], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()) + 1e-12, msg=k)


@pytest.mark.gpu
def test_flrelu_bwd_kernel_raises_on_unsupported_input(cuda_device):
    s = _layer("L0_36_1024")
    args = (s.up_filter, s.down_filter, None, s.up_factor, s.padding, 2 ** 0.5, 0.2, 256.0)
    x = torch.zeros((1, 36, 36, 8), device=cuda_device)
    dy = torch.zeros((1, 36, 36, 8), device=cuda_device)
    with pytest.raises(TypeError):  # fp16
        flrelu_cuda.filtered_lrelu_bwd_cuda(dy.half(), x.half(), *args)
    with pytest.raises(TypeError):  # dy and x of two dtypes
        flrelu_cuda.filtered_lrelu_bwd_cuda(dy.bfloat16(), x, *args)
    with pytest.raises(ValueError):  # not NHWC-contiguous
        flrelu_cuda.filtered_lrelu_bwd_cuda(dy, x.transpose(1, 2).contiguous().transpose(1, 2),
                                            *args)
    with pytest.raises(ValueError):  # dy of the wrong shape
        flrelu_cuda.filtered_lrelu_bwd_cuda(dy[:, 1:], x, *args)


# (Qh, Qw, C, taps): Qw, J = Qw - taps + 1 and C off the multiples of 8 and 16
# (MMA tiles, channel groups), and the probe's own shape. fir_banded cuts J
# into bands of at most 16 columns; J = 19 makes two of 10 and 9, and C = 44
# has whole 16-byte fp32 slices in all groups but the last.
FIR_SHAPES = [(20, 21, 8, 12), (37, 29, 45, 4), (40, 30, 44, 12), (76, 76, 128, 12)]
FIR_TOL = 1e-5  # of max |ref|: sum order; the split tf32 products keep ~2^-22


def _fir_plane(shape, dtype, device, seed):
    qh, qw, c, _ = shape
    x = np.random.RandomState(seed).randn(qh, qw, c).astype(np.float32)
    return torch.from_numpy(x).to(device, getattr(torch, dtype))


def _assert_fir_close(got, ref):
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = float((got - ref).abs().max())
    assert err <= FIR_TOL * float(ref.abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FIR_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fir_taps_kernel_matches_plain(cuda_device, shape, dtype):
    """Tap chains with different taps (and counts) along W and H."""
    p = _fir_plane(shape, dtype, cuda_device, seed=9)
    rng = np.random.RandomState(10)
    taps_w = rng.uniform(0, 1, shape[3]).astype(np.float32)
    taps_h = rng.uniform(0, 1, max(shape[3] - 3, 1)).astype(np.float32)
    before = fir_cuda.launches["fir_taps"]
    got = fir_taps(p, taps_w, taps_h)
    assert fir_cuda.launches["fir_taps"] == before + 1
    ref = fir_taps_ref(p, taps_w, taps_h)
    torch.cuda.synchronize()
    _assert_fir_close(got, ref)


# The tap kernel's own edges (Qh, Qw, C, Tw, Th, offset of the plane in
# elements): 64 and 1 taps, a one-row and a one-column output, strips of a
# wide row at 64 taps, and C = 45 (and the probe's C) on a plane that starts
# off a 16-byte boundary, which takes element loads.
FIR_TAPS_EDGES = [(70, 70, 16, 64, 61, 0), (70, 70, 16, 1, 1, 0), (9, 30, 16, 5, 9, 0),
                  (66, 40, 17, 40, 3, 0), (70, 2000, 16, 64, 64, 0), (40, 30, 45, 12, 9, 1),
                  (76, 76, 128, 12, 12, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("edge", FIR_TAPS_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fir_taps_kernel_edges_match_plain(cuda_device, edge, dtype):
    qh, qw, c, tw, th, offset = edge
    whole = _fir_plane((qh * qw * c + offset, 1, 1, 0), dtype, cuda_device, seed=14).flatten()
    p = whole[offset:].view(qh, qw, c)
    assert (p.data_ptr() % 16 != 0) == (offset != 0)
    rng = np.random.RandomState(15)
    taps_w = rng.uniform(0, 1, tw).astype(np.float32)
    taps_h = rng.uniform(0, 1, th).astype(np.float32)
    got = fir_taps(p, taps_w, taps_h)
    torch.cuda.synchronize()
    _assert_fir_close(got, fir_taps_ref(p, taps_w, taps_h))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [0, 1])
def test_fir_taps_keeps_two_blocks_per_sm_at_the_probe_shape(cuda_device, dtype):
    """At [76, 76, 16896] with 12 taps, at least two blocks share an SM, so
    one block's copies overlap another's chains."""
    lib = cuda_build.build()["fir_taps"]
    assert lib.sg3_fir_taps_blocks_per_sm(76, 76, 16896, 12, 12, dtype) >= 2
    assert 0 < lib.sg3_fir_taps_smem_bytes(76, 76, 16896, 12, 12, dtype) <= fir_cuda.SMEM_PER_BLOCK


@pytest.mark.gpu
def test_fir_taps_c_entry_refuses_what_the_wrapper_refuses(cuda_device):
    """Taps over 64, or more than the plane is wide or high: the wrapper
    raises ValueError, the C entries return cudaErrorInvalidValue (1), -1
    blocks per SM and 0 bytes, and launch nothing."""
    lib = cuda_build.build()["fir_taps"]
    out = torch.zeros(1, device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for qh, qw, tw, th in ((70, 70, 65, 4), (70, 70, 4, 65), (20, 21, 22, 4), (20, 21, 4, 21)):
        p = torch.zeros((qh, qw, 8), device=cuda_device)
        taps_w, taps_h = np.ones(tw, np.float32), np.ones(th, np.float32)
        with pytest.raises(ValueError):
            fir_cuda.fir_taps_cuda(p, taps_w, taps_h)
        assert lib.sg3_fir_taps(p.data_ptr(), taps_w.ctypes.data, taps_h.ctypes.data,
                                out.data_ptr(), 0, qh, qw, 8, tw, th, stream) == 1
        assert lib.sg3_fir_taps_blocks_per_sm(qh, qw, 8, tw, th, 0) == -1
        assert lib.sg3_fir_taps_smem_bytes(qh, qw, 8, tw, th, 0) == 0
    assert lib.sg3_fir_taps_blocks_per_sm(20, 21, 8, 4, 4, 2) == -1  # no such dtype
    torch.cuda.synchronize()
    assert float(out[0]) == 0


def _fir_matrices(kind, j_out, qw, i_out, qh, n):
    """Mw [J, Qw] and Mh [I, Qh] of one kind (numpy fp32)."""
    if kind == "dense":
        rng = np.random.RandomState(12)
        return (rng.uniform(-1, 1, (j_out, qw)).astype(np.float32),
                rng.uniform(-1, 1, (i_out, qh)).astype(np.float32))
    if kind == "holed":  # two taps and one 20 columns on: all-zero K steps inside a range
        out = []
        for rows, cols in ((j_out, qw), (i_out, qh)):
            m = banded(rows, cols, hann_taps(2))
            r = np.arange(rows)[np.arange(rows) + 20 < cols]
            m[r, r + 20] = 0.5
            out.append(m)
        return tuple(out)
    mw, mh = banded(j_out, qw, hann_taps(n)), banded(i_out, qh, hann_taps(n - 1))
    if kind == "zero_row":
        mw[j_out // 2] = 0
        mh[i_out // 2] = 0
    return mw, mh


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FIR_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("matrices", ["banded", "dense", "holed", "zero_row"])
def test_fir_banded_kernel_matches_plain(cuda_device, shape, dtype, matrices):
    """The probe's banded Hann matrices, dense random ones (the kernel must
    not rely on the band), banded ones with all-zero K steps inside a range
    and with an all-zero row, with I != J."""
    qh, qw, _, n = shape
    p = _fir_plane(shape, dtype, cuda_device, seed=11)
    j_out, i_out = qw - n + 1, qh - n + 2
    mw, mh = (torch.from_numpy(m).to(cuda_device, p.dtype)
              for m in _fir_matrices(matrices, j_out, qw, i_out, qh, n))
    before = fir_cuda.launches["fir_banded"]
    got = fir_banded(p, mw, mh)
    assert fir_cuda.launches["fir_banded"] == before + 1
    ref = fir_banded_ref(p, mw, mh)
    torch.cuda.synchronize()
    _assert_fir_close(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fir_banded_kernel_unaligned_plane(cuda_device, dtype):
    """A contiguous plane that starts off a 16-byte boundary takes element
    loads, with the same result."""
    shape = (40, 30, 48, 12)
    whole = _fir_plane((40 * 30 * 48 + 1, 1, 1, 0), dtype, cuda_device, seed=13).flatten()
    p = whole[1:].view(shape[:3])
    assert p.data_ptr() % 16 != 0
    mw, mh = (torch.from_numpy(m).to(cuda_device, p.dtype)
              for m in _fir_matrices("banded", 19, 30, 30, 40, 12))
    got = fir_banded(p, mw, mh)
    torch.cuda.synchronize()
    _assert_fir_close(got, fir_banded_ref(p, mw, mh))
    _assert_fir_close(fir_banded(p.clone(), mw, mh), fir_banded_ref(p, mw, mh))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [0, 1])
def test_fir_banded_keeps_two_blocks_per_sm_at_the_probe_shape(cuda_device, dtype):
    """At [76, 76, 16896] with 12 taps, at least two blocks share an SM, so
    one block's loads overlap another's products."""
    lib = cuda_build.build()["fir_banded"]
    assert lib.sg3_fir_banded_blocks_per_sm(76, 76, 65, 65, dtype) >= 2
    assert lib.sg3_fir_banded_smem_bytes(76, 76, 65, 65, dtype) <= fir_cuda.SMEM_PER_BLOCK


@pytest.mark.gpu
def test_fir_banded_c_entry_refuses_what_the_wrapper_refuses(cuda_device):
    """Shapes over the limits: the wrapper raises ValueError, the C entries
    return cudaErrorInvalidValue (1) and launch nothing."""
    lib = cuda_build.build()["fir_banded"]
    out = torch.zeros(1, device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for qh, qw, j, i in ((20, 129, 118, 9), (150, 21, 10, 139), (20, 140, 129, 9)):
        p = torch.zeros((qh, qw, 8), device=cuda_device)
        mw = torch.zeros((j, qw), device=cuda_device)
        mh = torch.zeros((i, qh), device=cuda_device)
        with pytest.raises(ValueError):
            fir_cuda.fir_banded_cuda(p, mw, mh)
        assert lib.sg3_fir_banded(p.data_ptr(), mw.data_ptr(), mh.data_ptr(), out.data_ptr(), 0,
                                  qh, qw, 8, j, i, stream) == 1
        assert lib.sg3_fir_banded_blocks_per_sm(qh, qw, j, i, 0) == -1
    assert lib.sg3_fir_banded_blocks_per_sm(20, 21, 10, 9, 2) == -1  # no such dtype
    torch.cuda.synchronize()
    assert float(out[0]) == 0


@pytest.mark.gpu
def test_fir_kernels_raise_on_unsupported_input(cuda_device):
    p = torch.zeros((20, 21, 8), device=cuda_device)
    taps = hann_taps(4)
    mw = torch.zeros((18, 21), device=cuda_device)
    mh = torch.zeros((17, 20), device=cuda_device)
    with pytest.raises(TypeError):  # fp16
        fir_cuda.fir_taps_cuda(p.half(), taps, taps)
    with pytest.raises(TypeError):
        fir_cuda.fir_banded_cuda(p.half(), mw.half(), mh.half())
    with pytest.raises(TypeError):  # matrices of another dtype than p
        fir_cuda.fir_banded_cuda(p, mw.bfloat16(), mh.bfloat16())
    q = p.transpose(0, 1).contiguous().transpose(0, 1)  # not contiguous
    with pytest.raises(ValueError):
        fir_cuda.fir_taps_cuda(q, taps, taps)
    with pytest.raises(ValueError):
        fir_cuda.fir_banded_cuda(q, mw, mh)
    with pytest.raises(ValueError):  # Mw's width is not Qw
        fir_cuda.fir_banded_cuda(p, mw[:, 1:].contiguous(), mh)
    with pytest.raises(ValueError):  # more taps than the plane is wide
        fir_cuda.fir_taps_cuda(p, hann_taps(22), taps)


# Slim SG3-R decoder for the ReStyle and editing tests: u=2 and u=4, radial
# and separable layers, the top resolutions in bf16 unless force_fp32.
SLIM_R = dict(channel_base=2048, channel_max=64, num_layers=6)


@pytest.mark.gpu
def test_restyle_through_the_kernels_matches_plain(cuda_device):
    """RestyleNet (e4e, IR-SE-50) on a slim SG3-R decoder on the card: the
    average image and two iterations with a landmarks transform, through the
    forward kernel's fp32 route (one launch per filtered layer per decode
    call; the dual decode is one call), against ``impl="ref"``. Images within
    atol 1e-3 (`chip_smoke.py`'s fp32 image tolerance), codes within 1e-3 of
    max |codes| (the second iteration encodes the first's image)."""
    from stylegan3_editing_tpu_torch.models.encoders import (RestyleNet, get_average_image,
                                                             run_restyle_iterations)

    cfg = sg3_r_config(64, **SLIM_R)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
    model = RestyleNet(cfg, "ProgressiveBackboneEncoder", n_styles=cfg.num_ws,
                       device=cuda_device)
    gen = torch.Generator().manual_seed(3)
    faces = (torch.rand((2, 256, 256, 3), generator=gen) * 2 - 1).to(cuda_device)
    lt = torch.eye(3)
    lt[0, 2] = 0.07
    out = {}
    for impl in ("auto", "ref"):
        flrelu_cuda.reset_launches()
        with torch.no_grad():
            avg, lat = get_average_image(model, impl=impl)
            out[impl] = [avg] + [t for a, u, c in run_restyle_iterations(
                model, faces, avg, lat, n_iters=2, landmarks_transform=lt.to(cuda_device),
                impl=impl) for t in (a, u, c)]
        torch.cuda.synchronize()
        assert flrelu_cuda.launches["filtered_lrelu_fwd"] == {"auto": 3 * n_layers,
                                                              "ref": 0}[impl]
    for i, (got, ref) in enumerate(zip(out["auto"], out["ref"])):
        codes = ref.ndim == 3 and ref.shape[-1] == 512
        atol = 1e-3 * float(ref.abs().max()) if codes else 1e-3
        torch.testing.assert_close(got, ref, rtol=0, atol=atol, msg=f"output {i}")


@pytest.mark.gpu
def test_face_editor_range_matches_per_factor_renders(cuda_device):
    """`FaceEditor` on the card: a factor range is one synthesis (one launch
    per filtered layer, bf16 route on the top layers), and each factor's
    images match that factor's own render at batch 2 within
    `RANGE_RENDER_TOL` of max |ref| (the styles are normalised over the whole
    batch, so the two batches round their bf16 inputs apart), while the
    neighbouring factors' images and the pair swapped lie beyond it."""
    from stylegan3_editing_tpu_torch.editing import FaceEditor
    from stylegan3_editing_tpu_torch.editing.interfacegan import RANGE_RENDER_TOL

    cfg = sg3_r_config(64, **SLIM_R)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
    G = Generator(cfg, device=cuda_device)
    gen = torch.Generator().manual_seed(4)
    d = torch.randn((1, 512), generator=gen)
    editor = FaceEditor(G, directions={"d": (d / d.norm()).numpy()})
    with torch.no_grad():
        ws = G.map(torch.randn((2, cfg.z_dim), generator=gen).to(cuda_device))
        flrelu_cuda.reset_launches()
        images, latents = editor.edit(ws, "d", factor_range=(-2, 3))
        torch.cuda.synchronize()
        assert flrelu_cuda.launches["filtered_lrelu_fwd"] == n_layers
        for i, (f, img, lat) in enumerate(zip(range(-2, 3), images, latents)):
            single, single_lat = editor.edit(ws, "d", factor=float(f))
            assert torch.equal(lat, single_lat)
            tol = RANGE_RENDER_TOL * float(single.abs().max())
            torch.testing.assert_close(img, single, rtol=0, atol=tol, msg=f"f={f}")
            faults = {f"factor {f + k}": images[i + k] for k in (-1, 1)
                      if 0 <= i + k < len(images)}
            faults["pair swapped"] = img.flip(0)
            for name, wrong in faults.items():
                err = float((wrong - single).abs().max())
                assert err > tol, f"f={f}: {name} reads {err:.3e}, within the tolerance {tol:.3e}"


@pytest.mark.gpu
def test_converted_generator_reproduces_the_source(cuda_device, tmp_path):
    """A slim SG3-R state dict in the reference's naming, through
    `convert_checkpoint`, loads into a fresh generator whose fp32 image
    through the kernels equals the source's bit for bit."""
    from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
    from stylegan3_editing_tpu_torch.models.sg3.convert import npz_to_variables
    from stylegan3_editing_tpu_torch.scripts import convert_checkpoint

    cfg = sg3_r_config(64, **SLIM_R)
    src = Generator(cfg, device=cuda_device, generator=torch.Generator().manual_seed(5))
    torch.save(reference_state(src), tmp_path / "G.pt")
    convert_checkpoint.convert(str(tmp_path / "G.pt"), str(tmp_path / "G"), res=64,
                               cfg_overrides=SLIM_R)
    G = Generator(cfg, device=cuda_device, generator=torch.Generator().manual_seed(6))
    load_jax_variables(G, npz_to_variables(tmp_path / "G.npz"))
    z = torch.randn((2, cfg.z_dim), generator=torch.Generator().manual_seed(7)).to(cuda_device)
    with torch.no_grad():
        assert torch.equal(G(z, force_fp32=True), src(z, force_fp32=True))


@pytest.mark.gpu
def test_run_pti_images_tune_through_the_kernels(cuda_device, tmp_path):
    """`run_pti_images.tune` per image on the card: one forward and one
    backward launch per filtered layer per image-pass (plus the final
    renders), finite results, and each image's tree, written by the CLI's
    writer, renders that image's final image."""
    from stylegan3_editing_tpu_torch.inversion import PTI, PTIOptions
    from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
    from stylegan3_editing_tpu_torch.models.sg3.convert import npz_to_variables
    from stylegan3_editing_tpu_torch.scripts import convert_checkpoint, run_pti_images

    cfg = sg3_r_config(64, **SLIM_R)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
    src = Generator(cfg, device=cuda_device, generator=torch.Generator().manual_seed(8))
    torch.save(reference_state(src), tmp_path / "G.pt")
    convert_checkpoint.convert(str(tmp_path / "G.pt"), str(tmp_path / "G"), res=64,
                               cfg_overrides=SLIM_R)
    G = run_pti_images.load_generator(str(tmp_path / "G.npz"), cfg, cuda_device)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        ws = G.map(torch.randn((2, cfg.z_dim), generator=gen).to(cuda_device))
        targets = G.synthesize(ws)
    pivot = ws + 0.3 * torch.randn(ws.shape, generator=gen).to(cuda_device)
    pti = PTI(G, opts=PTIOptions(lpips_threshold=0.0))
    flrelu_cuda.reset_launches()
    images, trees, log = run_pti_images.tune(pti, pivot, targets, batch_size=2, steps=2)
    torch.cuda.synchronize()
    assert flrelu_cuda.launches["filtered_lrelu_fwd"] == n_layers * (2 * 2 + 2)
    assert flrelu_cuda.launches["filtered_lrelu_bwd"] == n_layers * 2 * 2
    assert bool(torch.isfinite(images).all()) and len(trees) == 2
    assert all(np.isfinite(log[0]["lpips"]))
    base = npz_to_variables(tmp_path / "G.npz")
    for i, tree in enumerate(trees):
        run_pti_images.save_tuned(tree, tmp_path / f"{i}_model.npz")
        G2 = Generator(cfg, device=cuda_device)
        load_jax_variables(G2, run_pti_images.tuned_variables(
            base, npz_to_variables(tmp_path / f"{i}_model.npz")["synthesis_tuned"]))
        with torch.no_grad():
            again = G2.synthesize(pivot[i:i + 1], force_fp32=pti.force_fp32)
        torch.testing.assert_close(again[0], images[i], rtol=0, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("encoder_type", ["ResNetBackboneEncoder",
                                          "ResNetProgressiveBackboneEncoder"])
def test_resnet_restyle_through_the_kernels_matches_plain(cuda_device, encoder_type):
    """RestyleNet with a ResNet-34 trunk on a slim SG3-R decoder on the card,
    as `test_restyle_through_the_kernels_matches_plain` holds the IR-SE-50
    one: the average image and two iterations with a landmarks transform
    through the kernels against ``impl="ref"``."""
    from stylegan3_editing_tpu_torch.models.encoders import (RestyleNet, get_average_image,
                                                             run_restyle_iterations)

    cfg = sg3_r_config(64, **SLIM_R)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
    model = RestyleNet(cfg, encoder_type, n_styles=cfg.num_ws, device=cuda_device)
    faces = (torch.rand((2, 256, 256, 3), generator=torch.Generator().manual_seed(10)) * 2
             - 1).to(cuda_device)
    lt = torch.eye(3)
    lt[1, 2] = -0.05
    out = {}
    for impl in ("auto", "ref"):
        flrelu_cuda.reset_launches()
        with torch.no_grad():
            avg, lat = get_average_image(model, impl=impl)
            out[impl] = [avg] + [t for a, u, c in run_restyle_iterations(
                model, faces, avg, lat, n_iters=2, landmarks_transform=lt.to(cuda_device),
                impl=impl) for t in (a, u, c)]
        torch.cuda.synchronize()
        assert flrelu_cuda.launches["filtered_lrelu_fwd"] == {"auto": 3 * n_layers,
                                                              "ref": 0}[impl]
    for i, (got, ref) in enumerate(zip(out["auto"], out["ref"])):
        codes = ref.ndim == 3 and ref.shape[-1] == 512
        atol = 1e-3 * float(ref.abs().max()) if codes else 1e-3
        torch.testing.assert_close(got, ref, rtol=0, atol=atol, msg=f"output {i}")


@pytest.mark.gpu
def test_expander_on_the_card(cuda_device):
    """`Expander` with every margin: 9 views in one synthesize (one launch per
    filtered layer, the bf16 route on the top layers); the canvas' centre
    matches a batch-1 render within `RANGE_RENDER_TOL` of max |ref| (the
    generator tests' bf16 image tolerance), and the unshifted left view read
    there lies beyond it."""
    from stylegan3_editing_tpu_torch.editing.interfacegan import RANGE_RENDER_TOL
    from stylegan3_editing_tpu_torch.utils.common import make_transform
    from stylegan3_editing_tpu_torch.utils.fov_expansion import Expander

    cfg = sg3_r_config(64, **SLIM_R)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
    G = Generator(cfg, device=cuda_device)
    lt = make_transform((0.03, -0.02), 4.0)
    exp = Expander(G, 64)
    with torch.no_grad():
        ws = G.map(torch.randn((1, cfg.z_dim), generator=torch.Generator().manual_seed(11))
                   .to(cuda_device), truncation_psi=0.7)
        flrelu_cuda.reset_launches()
        canvas = exp.generate_expanded_image(ws, lt, 16, 16, 16, 16)
        torch.cuda.synchronize()
        assert flrelu_cuda.launches["filtered_lrelu_fwd"] == n_layers
        assert canvas.shape == (1, 96, 96, 3)
        plain = G.synthesize(ws, transform=torch.from_numpy(lt).float().to(cuda_device))
        tol = RANGE_RENDER_TOL * float(plain.abs().max())
        torch.testing.assert_close(canvas[:, 16:80, 16:80], plain, rtol=0, atol=tol)
        left = exp.views(ws, lt, 16, 16, 16, 16)["left"]
        assert float((left - plain).abs().max()) > tol


@pytest.mark.gpu
def test_styleclip_edit_through_the_kernels_matches_plain(cuda_device, tmp_path):
    """A StyleCLIP global-direction edit on the card: a tiny CLIP and BPE
    vocabulary, a seeded ``delta_i_c``, `get_delta_s`, `apply_delta_s` and
    one `synthesize(all_s=…)` at batch 2 (one launch per filtered layer,
    the bf16 route on the top layers); the same StyleSpace in the fp32
    route through the kernels against ``impl="ref"`` within atol 1e-3
    (`chip_smoke.py`'s fp32 image tolerance), which the unedited render
    misses. (In bf16 the kernel rounds once a layer and the plain
    composition at every op, so the two routes' renders differ by the bf16
    policy's own error, held per layer elsewhere.)"""
    import gzip

    from stylegan3_editing_tpu_torch.editing.styleclip_global import (
        DEFAULT_TEMPLATES, StyleCLIPGlobalDirection, apply_delta_s, s_key_order)
    from stylegan3_editing_tpu_torch.models.backbones.clip import CLIP, SimpleTokenizer

    cfg = sg3_r_config(64, **SLIM_R)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
    G = Generator(cfg, device=cuda_device)
    clip = CLIP(embed_dim=32, image_resolution=64, vision_width=64, vision_layers=2,
                text_width=64, text_layers=2, text_heads=1, device=cuda_device)
    with gzip.open(tmp_path / "vocab.txt.gz", "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\nf a\nfa c\nfac e</w>\ns m\nsm i\nsmi l\nsmil i\nsmili n\n")
    rng = np.random.RandomState(12)
    with torch.no_grad():
        ws = G.map(torch.from_numpy(rng.randn(2, cfg.z_dim).astype(np.float32)).to(cuda_device),
                   truncation_psi=0.7)
        all_s = G.w2s(ws)
        keys = s_key_order(all_s)
        s_std = {k: all_s[k].std(0).cpu().numpy() + 0.1 for k in keys}
        s_avg = {k: all_s[k].mean(0, keepdim=True).cpu().numpy() for k in keys}
        d_ic = rng.randn(sum(v.shape[-1] for v in s_std.values()), 32).astype(np.float32)
        gd = StyleCLIPGlobalDirection(d_ic, s_std, DEFAULT_TEMPLATES, s_avg, clip,
                                      SimpleTokenizer(str(tmp_path / "vocab.txt.gz")))
        edited = apply_delta_s(all_s, gd.get_delta_s("face", "smiling face", 0.05), 2.0)
        flrelu_cuda.reset_launches()
        img = G.synthesize(None, all_s=edited)
        torch.cuda.synchronize()
        assert flrelu_cuda.launches["filtered_lrelu_fwd"] == n_layers
        assert img.shape == (2, 64, 64, 3) and torch.isfinite(img).all()
        got = G.synthesize(None, all_s=edited, force_fp32=True)
        ref = G.synthesize(None, all_s=edited, force_fp32=True, impl="ref")
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)
        plain = G.synthesize(None, all_s=all_s, force_fp32=True, impl="ref")
        assert float((plain - ref).abs().max()) > 1e-3


ALL_LAYERS = [s.name for s in build_synthesis_layout(sg3_r_config(1024)).layers
              if s.up_filter is not None]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ALL_LAYERS)
def test_flrelu_bwd_kernel_fp32_route_at_batch_2(cuda_device, name):
    """The backward kernel's fp32 route, which the StyleCLIP mapper's step
    runs on every layer at batch 2 (`force_fp32=True`, bf16 layers
    included): dx against `filtered_lrelu_bwd_ref` within atol = rtol =
    1e-4 (sum order), at a reduced size with a ragged channel count, x scaled
    so that the clamp bites."""
    s = _layer(name)
    rng = np.random.RandomState(13)
    hi, c = max(s.in_size[1] // 8, 40), min(s.out_channels, 45)
    x = torch.from_numpy(rng.randn(2, hi, hi, c).astype(np.float32) * 150).to(cuda_device)
    b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda_device)
    out = flrelu_cuda.output_size(hi, s.up_factor, s.padding[2], s.padding[3],
                                  len(s.up_filter), s.down_filter.shape[0])
    out_w = flrelu_cuda.output_size(hi, s.up_factor, s.padding[0], s.padding[1],
                                    len(s.up_filter), s.down_filter.shape[0])
    dy = torch.from_numpy(rng.randn(2, out, out_w, c).astype(np.float32)).to(cuda_device)
    before = flrelu_cuda.launches["filtered_lrelu_bwd"]
    got = flrelu_cuda.filtered_lrelu_bwd_cuda(dy, x, s.up_filter, s.down_filter, b, s.up_factor,
                                              s.padding, 2 ** 0.5, 0.2, s.conv_clamp)
    assert flrelu_cuda.launches["filtered_lrelu_bwd"] == before + 1
    ref = filtered_lrelu_bwd_ref(dy, x, s.up_filter, s.down_filter, b, s.up_factor, s.padding,
                                 clamp=s.conv_clamp)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == x.shape
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_mapper_step_through_the_kernels_matches_plain(cuda_device):
    """One StyleCLIP mapper step (all three losses) on a slim SG3-R 64² with
    a small CLIP at 224² and the 8-layer IR-SE trunk: each filtered layer
    launches the forward kernel twice (ŵ's image and ``x_orig``) and the
    backward kernel once (the decoder is frozen: dx only); the losses and
    every mapper gradient through the kernels against ``impl="ref"`` within
    1e-3 of the tensor's largest |grad| (`chip_smoke.py`'s `GRAD_TOL`)."""
    from stylegan3_editing_tpu_torch.editing.styleclip_mapper import (MapperCoach,
                                                                     MapperTrainOptions)
    from stylegan3_editing_tpu_torch.models.backbones.clip import CLIP
    from stylegan3_editing_tpu_torch.models.backbones.irse import IRSEBackbone

    cfg = sg3_r_config(64, channel_base=2048, channel_max=64, num_layers=7)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
    gen = torch.Generator().manual_seed(21)
    tokens = np.zeros((1, 77), np.int64)
    tokens[0, :4] = (49406, 320, 1125, 49407)
    coach = MapperCoach(
        MapperTrainOptions(stylegan_size=64), cfg,
        clip_model=CLIP(embed_dim=32, image_resolution=224, vision_width=64, vision_layers=2,
                        text_width=32, text_layers=2, text_heads=4, device=cuda_device,
                        generator=gen),
        facenet=IRSEBackbone(112, 8, "ir_se", generator=gen).to(cuda_device),
        text_tokens=tokens, device=cuda_device)
    w = coach.net.decoder.map(torch.randn((2, cfg.z_dim), generator=gen).to(cuda_device),
                              truncation_psi=0.7)
    runs = {}
    for impl in ("auto", "ref"):
        flrelu_cuda.reset_launches()
        runs[impl] = coach.loss_and_grads(w, impl=impl)
        torch.cuda.synchronize()
        want = {"auto": n_layers, "ref": 0}[impl]
        assert flrelu_cuda.launches == {"filtered_lrelu_fwd": 2 * want,
                                        "filtered_lrelu_bwd": want, "fir_taps": 0,
                                        "fir_banded": 0}
    assert all(p.grad is None for p in coach.net.decoder.parameters())
    (m_auto, g_auto), (m_ref, g_ref) = runs["auto"], runs["ref"]
    assert all(np.isfinite(v) for v in m_auto.values())
    for k, v in m_ref.items():
        assert abs(m_auto[k] - v) <= 1e-4 * abs(v) + 2.0 ** -20, (k, m_auto[k], v)
    assert g_auto.keys() == g_ref.keys() and g_auto
    for k, g in g_ref.items():
        torch.testing.assert_close(g_auto[k], g, rtol=0,
                                   atol=1e-3 * float(g.abs().max()) + 1e-30, msg=k)


@pytest.fixture
def slim_restyle_nets(monkeypatch):
    """The 8-layer IR-SE trunk in the ReStyle encoders and the ID loss."""
    import functools

    from stylegan3_editing_tpu_torch.criteria import id_loss
    from stylegan3_editing_tpu_torch.models.backbones.irse import IRSEBackbone
    from stylegan3_editing_tpu_torch.models.encoders import backbones, restyle

    for name in ("BackboneEncoder", "ProgressiveBackboneEncoder"):
        monkeypatch.setitem(restyle.ENCODER_TYPES, name,
                            functools.partial(getattr(backbones, name), num_layers=8))
    monkeypatch.setattr(id_loss, "IRSEBackbone", lambda input_size, num_layers, mode, **kw:
                        IRSEBackbone(input_size, 8, mode, **kw))


def _restyle_coach(cuda_device, **kw):
    from stylegan3_editing_tpu_torch.training import Coach, TrainOptions

    cfg = sg3_r_config(64, channel_base=2048, channel_max=64, num_layers=7)
    opts = TrainOptions(**{**dict(batch_size=2, effective_batch_size=8, n_iters_per_batch=3,
                                  lpips_lambda=0.8, l2_lambda=1.0, id_lambda=0.1,
                                  output_size=64, exp_dir="unused"), **kw})
    coach = Coach(opts, cfg, device=cuda_device)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
    return coach, n_layers


def _faces(n, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    return [tuple(torch.tanh(torch.randn((batch, 256, 256, 3), generator=gen)).numpy()
                  for _ in range(2)) for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("train_decoder", [False, True])
def test_restyle_coach_micro_steps_launch_both_kernels(cuda_device, slim_restyle_nets,
                                                       train_decoder):
    """Four pSp micro-steps (the README's FFHQ losses, batch 2, 3 iterations,
    an effective batch of 8) on a slim SG3-R 64²: each micro-step launches
    the forward and the backward kernel once per filtered layer and
    iteration; the encoder's parameters move at the fourth micro-step only,
    its batch-norm statistics at every one; the decoder and the loss nets get
    no gradient unless ``train_decoder`` (then the backward also gives db)."""
    coach, n_layers = _restyle_coach(cuda_device, train_decoder=train_decoder)
    encoder = [p for n, p in coach.trainable if n.startswith("encoder.")]
    for i, batch in enumerate(_faces(4, 2, seed=31)):
        before = [p.detach().clone() for p in encoder]
        stats = coach.model.encoder.trunk.input_bn.mean.clone()
        flrelu_cuda.reset_launches()
        metrics = coach.train_step(batch)
        torch.cuda.synchronize()
        want = 3 * n_layers
        assert flrelu_cuda.launches == {"filtered_lrelu_fwd": want, "filtered_lrelu_bwd": want,
                                        "fir_taps": 0, "fir_banded": 0}
        assert all(np.isfinite(v) for v in metrics.values())
        moved = any(not torch.equal(a, p) for a, p in zip(before, encoder))
        assert moved == (i == 3)
        assert not torch.equal(stats, coach.model.encoder.trunk.input_bn.mean)
    for net in coach.loss_nets().values():
        assert all(p.grad is None and not p.requires_grad for p in net.parameters())
    assert all(p.requires_grad == train_decoder for p in coach.model.decoder.parameters())
    assert any(n.startswith("decoder.") for n, _ in coach.trainable) == train_decoder


@pytest.mark.gpu
def test_restyle_coach_step_through_the_kernels_matches_plain(cuda_device, slim_restyle_nets):
    """One pSp micro-step's forward and backward at batch 1 through the
    kernels against ``impl="ref"``: the losses within 1e-4 relative plus
    2⁻²⁰, every encoder gradient within 1e-3 of the encoder gradient's
    largest |entry| (`chip_smoke.py` phase 14 (c): the train-mode batch norms
    cancel some tensors' gradients to rounding noise)."""
    coach, n_layers = _restyle_coach(cuda_device, batch_size=1, effective_batch_size=1)
    batch = _faces(1, 1, seed=32)[0]
    runs = {}
    for impl in ("auto", "ref"):
        flrelu_cuda.reset_launches()
        runs[impl] = coach.loss_and_grads(batch, impl=impl)
        torch.cuda.synchronize()
        want = {"auto": 3 * n_layers, "ref": 0}[impl]
        assert flrelu_cuda.launches == {"filtered_lrelu_fwd": want,
                                        "filtered_lrelu_bwd": want, "fir_taps": 0,
                                        "fir_banded": 0}
    (m_auto, g_auto), (m_ref, g_ref) = runs["auto"], runs["ref"]
    for k, v in m_ref.items():
        assert abs(m_auto[k] - v) <= 1e-4 * abs(v) + 2.0 ** -20, (k, m_auto[k], v)
    scale = max(float(g.abs().max()) for g in g_ref.values())
    for k, g in g_ref.items():
        torch.testing.assert_close(g_auto[k], g, rtol=0, atol=1e-3 * scale, msg=k)


SLIM_T = dict(channel_base=1024, channel_max=32, num_layers=4)  # a slim SG3-T stem


@pytest.mark.gpu
def test_setgan_through_the_kernels_matches_plain(cuda_device):
    """A slim SetGAN (SG3-T 64² stem, the 8-layer IR-SE trunk) on padded
    reference sets: one launch per filtered layer a call, fp32 images
    through the kernels within 1e-3 of ``impl="ref"`` (the fp32 route is
    the plain version's arithmetic), and a padded slot's contents change
    no candidate."""
    from stylegan3_editing_tpu_torch.setgan import SetGAN

    cfg = sg3_t_config(64, **SLIM_T)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
    g = SetGAN(cfg, attn_layers=1, encoder_num_layers=8, mean_center=True,
               device=cuda_device).eval()
    gen = torch.Generator().manual_seed(5)
    x = (torch.rand((2, 3, 64, 64, 3), generator=gen) * 2 - 1).to(cuda_device)
    z = torch.randn((2, 2, 512), generator=gen).to(cuda_device)
    mask = torch.tensor([[True, True, False], [True, True, True]], device=cuda_device)
    la = g.decoder.mapping.w_avg
    with torch.no_grad():
        flrelu_cuda.reset_launches()
        got = g(x, z, latent_avg=la, ref_mask=mask, force_fp32=True)
        assert flrelu_cuda.launches["filtered_lrelu_fwd"] == n_layers
        ref = g(x, z, latent_avg=la, ref_mask=mask, force_fp32=True, impl="ref")
        other = x.clone()
        other[0, 2] = x[1, 0]
        padded = g(other, z, latent_avg=la, ref_mask=mask, force_fp32=True)
    assert got.shape == (2, 2, 64, 64, 3) and torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 1e-3
    assert float((padded - got).abs().max()) <= 1e-5 * float(got.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["vgg", "squeeze", "msssim"])
def test_evaluation_criteria_card_matches_cpu(cuda_device, net):
    """LPIPS on the VGG16 and SqueezeNet trunks and MS-SSIM, per image, on
    the card against the CPU within 1e-4 of max |ref| (fp32 sum order)."""
    from stylegan3_editing_tpu_torch.criteria import LPIPS, msssim

    gen = torch.Generator().manual_seed(6)
    x = torch.rand((3, 96, 96, 3), generator=gen) * 2 - 1
    y = (x + 0.3 * torch.randn(x.shape, generator=gen)).clamp(-1, 1)
    if net == "msssim":
        cpu = gpu = lambda a, b: msssim(a, b, size_average=False)
    else:
        cpu = LPIPS(net, device="cpu", generator=torch.Generator().manual_seed(7)).per_image
        gpu = LPIPS(net, device=cuda_device,
                    generator=torch.Generator().manual_seed(7)).per_image
    with torch.no_grad():
        want, got = cpu(x, y), gpu(x.to(cuda_device), y.to(cuda_device)).cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


SLIM_T_LAYERS = [s.name for s in build_synthesis_layout(sg3_t_config(64, **SLIM_T)).layers
                 if s.up_filter is not None]


@pytest.mark.gpu
@pytest.mark.parametrize("name", SLIM_T_LAYERS)
def test_flrelu_bwd_kernel_on_slim_sg3t_layers(cuda_device, name):
    """The backward kernel on a slim SG3-T's layers (separable filters: the
    dy up pass on the CUDA cores), in each layer's dtype, as SetGAN's G step
    runs it: dx against `filtered_lrelu_bwd_ref` on the upcast inputs (fp32:
    atol = rtol = 1e-4; bf16: one bf16 rounding, rtol 2^-8, atol 1e-3), and
    db = Σ dx within 1e-4 (fp32) or 2^-6 (bf16) of max |db|. x is scaled so
    that the clamp of 256 bites."""
    s = next(s for s in build_synthesis_layout(sg3_t_config(64, **SLIM_T)).layers
             if s.name == name)
    dt = torch.bfloat16 if s.use_bf16 else torch.float32
    rng = np.random.RandomState(17)
    x = torch.from_numpy(rng.randn(2, s.in_size[1], s.in_size[0], s.out_channels)
                         .astype(np.float32) * 60).to(cuda_device, dt)
    b = torch.from_numpy(rng.randn(s.out_channels).astype(np.float32)).to(cuda_device, dt)
    out_h, out_w = (flrelu_cuda.output_size(side, s.up_factor, p0, p1, len(s.up_filter),
                                            s.down_filter.shape[0])
                    for side, p0, p1 in ((s.in_size[1], s.padding[2], s.padding[3]),
                                         (s.in_size[0], s.padding[0], s.padding[1])))
    dy = torch.from_numpy(rng.randn(2, out_h, out_w, s.out_channels)
                          .astype(np.float32)).to(cuda_device, dt)
    before = flrelu_cuda.launches["filtered_lrelu_bwd"]
    got = flrelu_cuda.filtered_lrelu_bwd_cuda(dy, x, s.up_filter, s.down_filter, b,
                                              s.up_factor, s.padding, 2 ** 0.5, 0.2, s.conv_clamp)
    assert flrelu_cuda.launches["filtered_lrelu_bwd"] == before + 1
    ref = filtered_lrelu_bwd_ref(dy.float(), x.float(), s.up_filter, s.down_filter, b.float(),
                                 s.up_factor, s.padding, clamp=s.conv_clamp)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == x.shape
    atol, rtol = (1e-3, 2 ** -8) if s.use_bf16 else (1e-4, 1e-4)
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)
    db, db_ref = got.float().sum((0, 1, 2)), ref.sum((0, 1, 2))
    tol = (2 ** -6 if s.use_bf16 else 1e-4) * float(db_ref.abs().max())
    assert float((db - db_ref).abs().max()) <= tol


@pytest.mark.gpu
def test_setgan_train_step_through_the_kernels_matches_plain(cuda_device):
    """A slim SetGAN trainer (SG3-T 64² stem, the 8-layer IR-SE trunk,
    ``tiny_proj``): one D step's and one G step's losses and gradients in
    fp32 through the kernels against ``impl="ref"`` from the same state,
    noise and draws (losses within 1e-4 relative + 2^-20; each gradient
    within 1e-3 of its group's largest |entry|). The G step launches the
    forward kernel once and the backward kernel once per filtered layer;
    the D step's G runs without a graph (forward only)."""
    from stylegan3_editing_tpu_torch.setgan import SetGANTrainConfig, SetGANTrainer

    cfg = sg3_t_config(64, **SLIM_T)
    n_layers = len(SLIM_T_LAYERS)
    tr = SetGANTrainer(SetGANTrainConfig(batch_size=2, d_backbones=("tiny_proj",),
                                         encoder_num_layers=8, g_attn_layers=1,
                                         d_attn_layers=1, d_latent_size=32), cfg,
                       device=cuda_device)
    gen = torch.Generator().manual_seed(9)
    batch = {"reference": (torch.rand((2, 3, 64, 64, 3), generator=gen) * 2 - 1),
             "ref_mask": torch.tensor([[True, True, False], [True, True, True]]),
             "candidate": (torch.rand((2, 2, 64, 64, 3), generator=gen) * 2 - 1),
             "cand_mask": torch.tensor([[True, False], [True, True]])}
    placed = tr._place(batch)
    z = torch.randn((2, 2, cfg.z_dim), generator=gen).to(cuda_device)
    draws = tr.draw(2, 2)
    runs = {}
    for impl in ("auto", "ref"):
        flrelu_cuda.reset_launches()
        d_loss, _, d_grads = tr.d_loss_and_grads(placed, z, draws, 2.0, force_fp32=True,
                                                 impl=impl)
        assert flrelu_cuda.launches["filtered_lrelu_bwd"] == 0
        flrelu_cuda.reset_launches()
        g_loss, _, g_grads = tr.g_loss_and_grads(placed, z, draws, 2.0, force_fp32=True,
                                                 impl=impl)
        torch.cuda.synchronize()
        want = {"auto": n_layers, "ref": 0}[impl]
        assert flrelu_cuda.launches == {"filtered_lrelu_fwd": want, "filtered_lrelu_bwd": want,
                                        "fir_taps": 0, "fir_banded": 0}
        runs[impl] = (float(d_loss), float(g_loss), d_grads, g_grads)
    for i in (0, 1):
        assert abs(runs["auto"][i] - runs["ref"][i]) <= 1e-4 * abs(runs["ref"][i]) + 2.0 ** -20
    for i in (2, 3):
        scale = max(float(g.abs().max()) for g in runs["ref"][i].values())
        for k, g in runs["ref"][i].items():
            torch.testing.assert_close(runs["auto"][i][k], g, rtol=0, atol=1e-3 * scale, msg=k)


@pytest.mark.gpu
def test_double_backward_through_the_fused_filtered_lrelu_raises(cuda_device):
    """The backward kernel's dx carries no graph: a second derivative through
    `FusedFilteredLrelu` (a path-length penalty's) raises instead of
    dropping its terms."""
    s = next(s for s in build_synthesis_layout(sg3_t_config(64, **SLIM_T)).layers
             if s.up_filter is not None)
    rng = np.random.RandomState(19)
    x = torch.from_numpy(rng.randn(1, s.in_size[1], s.in_size[0], s.out_channels)
                         .astype(np.float32)).to(cuda_device).requires_grad_(True)
    b = torch.from_numpy(rng.randn(s.out_channels).astype(np.float32)).to(cuda_device)
    y = filtered_lrelu(x, fu=s.up_filter, fd=s.down_filter, b=b, up=s.up_factor,
                       down=s.down_factor, padding=s.padding, clamp=s.conv_clamp)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["inception_v3", "densenet121", "regnety_002", "clip_vit_b32"])
def test_fid_network_and_new_families_card_match_cpu(cuda_device, name):
    """InceptionV3 (the FID's 2048-d features) and new registry families
    (their four stages) at a slim batch of 2, seeded, on the card against
    the CPU within 1e-4 of max |ref| (fp32 sum order; TF32 would read ~1e-3)."""
    from stylegan3_editing_tpu_torch.models.backbones.inception import InceptionV3Features
    from stylegan3_editing_tpu_torch.models.backbones.registry import make_feature_network

    gen = torch.Generator().manual_seed(21)
    if name == "inception_v3":
        net, side = InceptionV3Features(generator=gen), 64
    else:
        net, spec = make_feature_network(name, generator=gen)
        side = spec.fixed_input_res or 64
    x = torch.rand((2, side, side, 3), generator=gen) * 2 - 1
    on_card = copy.deepcopy(net).to(cuda_device)
    with torch.no_grad():
        want, got = net.eval()(x), on_card.eval()(x.to(cuda_device))
    for w, g in (zip(want, got) if isinstance(want, list) else [(want, got)]):
        assert torch.isfinite(g).all() and g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.gpu
def test_fid_evaluation_through_the_kernels_matches_plain(cuda_device, tmp_path):
    """`train_setgan.make_fid_eval_fn` on a slim trainer (SG3-T 64² stem,
    the 8-layer IR-SE trunk) over 2 classes of 2 images: 7 launches a
    `generate` call through the kernels, and the FID with the generator's
    fp32 route through the kernels within 1e-3 relative of the same with
    ``impl="ref"`` (the fp32 route is the plain version's arithmetic)."""
    import functools

    from stylegan3_editing_tpu_torch.scripts import train_setgan
    from stylegan3_editing_tpu_torch.setgan import SetGANTrainConfig, SetGANTrainer

    cfg = sg3_t_config(64, **SLIM_T)
    tr = SetGANTrainer(SetGANTrainConfig(batch_size=2, d_backbones=("tiny_proj",),
                                         encoder_num_layers=8, g_attn_layers=1,
                                         d_attn_layers=1, d_latent_size=32), cfg,
                       device=cuda_device)

    class Classes:
        images = np.tanh(np.random.RandomState(22).randn(4, 64, 64, 3)).astype(np.float32)
        classes = ["a", "b"]
        class_to_paths = {"a": [0, 1], "b": [2, 3]}

        def load(self, i):
            return self.images[i]

    opts = train_setgan.SetGANCliOptions(device="cuda", fid_classes=2, fid_items_per_class=2)
    run_g, fids = tr._run_g, {}
    for impl in ("auto", "ref"):
        tr._run_g = functools.partial(run_g, force_fp32=True, impl=impl)
        flrelu_cuda.reset_launches()
        fids[impl] = train_setgan.make_fid_eval_fn(opts, Classes())(tr)
        torch.cuda.synchronize()
        n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(cfg).layers)
        assert flrelu_cuda.launches["filtered_lrelu_fwd"] == (2 * n_layers if impl == "auto"
                                                              else 0)
    assert np.isfinite(fids["auto"]) and fids["auto"] >= 0
    assert abs(fids["auto"] - fids["ref"]) <= 1e-3 * abs(fids["ref"])
