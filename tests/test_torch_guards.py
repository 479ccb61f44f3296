"""Guards of the PyTorch port: no JAX at run time, no quiet CPU or plain fallback."""

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stylegan3_editing_tpu_torch.models.backbones.common import Conv2d
from stylegan3_editing_tpu_torch.models.sg3 import Generator, sg3_r_config, sg3_t_config
from stylegan3_editing_tpu_torch.models.sg3.config import build_synthesis_layout
from stylegan3_editing_tpu_torch.ops import cuda_build, fir_cuda, flrelu_cuda
from stylegan3_editing_tpu_torch.device import kernel_or_plain
from stylegan3_editing_tpu_torch.ops.banded_fir import (banded, fir_banded, fir_banded_ref,
                                                        fir_taps, fir_taps_ref, hann_taps)
from stylegan3_editing_tpu_torch.ops.filtered_lrelu import choose_impl
from stylegan3_editing_tpu_torch.ops.modulated_conv import modulated_conv2d
from stylegan3_editing_tpu_torch.ops.upfirdn2d import upfirdn2d

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "flax", "stylegan3_editing_tpu"}
PORT_FILES = sorted((ROOT / "stylegan3_editing_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, json; import stylegan3_editing_tpu_torch.models.sg3, "
            "stylegan3_editing_tpu_torch.ops, stylegan3_editing_tpu_torch.criteria, "
            "stylegan3_editing_tpu_torch.inversion, "
            "stylegan3_editing_tpu_torch.scripts.exp_mxu_down; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'stylegan3_editing_tpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_generator_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = sg3_r_config(32, channel_base=1024, channel_max=32, num_layers=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(cfg)
    with pytest.raises(RuntimeError):
        Generator(cfg, device="cuda")


def _specs():
    layers = build_synthesis_layout(sg3_r_config(1024)).layers
    return [s for s in layers if s.up_filter is not None], layers[-1]


@pytest.mark.parametrize("device_type,impl,expected", [
    ("cuda", "auto", "cuda"), ("cpu", "auto", "ref"), ("cuda", "ref", "ref"),
    ("cpu", "ref", "ref")])
def test_dispatch_by_device_type(device_type, impl, expected):
    flrelu_layers, torgb = _specs()
    assert len(flrelu_layers) == 14
    for s in flrelu_layers:
        assert choose_impl(device_type, s.up_filter, s.down_filter, s.up_factor,
                           s.down_factor, impl=impl) == expected, s.name
    # ToRGB (up = down = 1, no filters) is outside the kernel's envelope.
    assert choose_impl(device_type, torgb.up_filter, torgb.down_filter,
                       torgb.up_factor, torgb.down_factor, impl=impl) == "ref"


def test_dispatch_rejects_other_devices_and_impls():
    s = _specs()[0][0]
    with pytest.raises(ValueError):
        choose_impl("mps", s.up_filter, s.down_filter, 2, 2)
    with pytest.raises(ValueError):
        choose_impl("cuda", s.up_filter, s.down_filter, 2, 2, impl="xla")


def test_kernel_wrapper_refuses_cpu_tensors():
    s = _specs()[0][0]
    x = torch.zeros((1, 36, 36, 4))
    with pytest.raises(ValueError, match="CUDA"):
        flrelu_cuda.filtered_lrelu_cuda(x, s.up_filter, s.down_filter, None, 2,
                                        s.padding, 2 ** 0.5, 0.2, 256.0)


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    s = _specs()[0][0]
    x = torch.zeros((1, 36, 36, 4))
    with pytest.raises(ValueError, match="CUDA"):
        flrelu_cuda.filtered_lrelu_bwd_cuda(x, x, s.up_filter, s.down_filter, None, 2,
                                            s.padding, 2 ** 0.5, 0.2, 256.0)


def test_kernel_output_size_matches_layout():
    for s in _specs()[0]:
        tu, td = len(s.up_filter), s.down_filter.shape[0]
        px0, px1, py0, py1 = s.padding
        assert flrelu_cuda.output_size(s.in_size[1], s.up_factor, py0, py1, tu, td) \
            == s.out_size[1]
        assert flrelu_cuda.output_size(s.in_size[0], s.up_factor, px0, px1, tu, td) \
            == s.out_size[0]
        assert np.ndim(s.down_filter) == (2 if s.down_radial else 1)


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card it exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bwd_versions_script_needs_a_card(tmp_path):
    """The backward-versions timing script raises before it builds anything
    when there is no card, and rejects an order with an unknown label."""
    from stylegan3_editing_tpu_torch.scripts import bwd_versions
    src = tmp_path / "filtered_lrelu_bwd.cu"
    src.write_text("")
    with pytest.raises(AssertionError):
        bwd_versions.main([f"a={src}", "--order", "a,b"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bwd_versions.main([f"a={src}"])


def test_fir_versions_script_needs_a_card(tmp_path):
    """The banded kernel's versions script rejects an order with an unknown
    label and raises before it builds anything when there is no card."""
    from stylegan3_editing_tpu_torch.scripts import fir_versions
    src = tmp_path / "fir_banded.cu"
    src.write_text("")
    with pytest.raises(AssertionError):
        fir_versions.main([f"a={src}", "--order", "a,b"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fir_versions.main([f"a={src}"])


def test_fir_versions_script_takes_the_tap_kernel(tmp_path):
    """`--kernel fir_taps` picks the tap-chain kernel; an unknown kernel is a
    usage error; without a card it raises before it builds anything."""
    from stylegan3_editing_tpu_torch.scripts import fir_versions
    src = tmp_path / "fir_taps.cu"
    src.write_text("")
    with pytest.raises(SystemExit):
        fir_versions.main([f"a={src}", "--kernel", "fir_vpu"])
    with pytest.raises(AssertionError):
        fir_versions.main([f"a={src}", "--kernel", "fir_taps", "--order", "a,b"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fir_versions.main([f"a={src}", "--kernel", "fir_taps"])


def test_version_turns_mirror_the_order_and_average_each_label():
    from stylegan3_editing_tpu_torch.scripts import version_turns
    args, sources, order = version_turns.parse(["a=x/k.cu", "b=y/k.cu"], "d", "k.cu", iters=3)
    assert order == ["a", "b", "b", "a"] and args.iters == 3
    assert {label: str(path) for label, path in sources.items()} == {"a": "x/k.cu", "b": "y/k.cu"}
    assert version_turns.means(order, [1.0, 2.0, 4.0, 3.0]) == {"a": 2.0, "b": 3.0}


def test_fir_kernel_wrappers_refuse_cpu_tensors():
    p, taps = torch.zeros((20, 21, 8)), hann_taps(4)
    with pytest.raises(ValueError, match="CUDA"):
        fir_cuda.fir_taps_cuda(p, taps, taps)
    with pytest.raises(ValueError, match="CUDA"):
        fir_cuda.fir_banded_cuda(p, torch.zeros((18, 21)), torch.zeros((17, 20)))


@pytest.mark.parametrize("device_type,impl,expected", [
    ("cuda", "auto", "cuda"), ("cpu", "auto", "ref"), ("cuda", "ref", "ref"),
    ("cpu", "ref", "ref")])
def test_fir_dispatch_by_device_type(device_type, impl, expected):
    assert kernel_or_plain(device_type, impl) == expected


def test_fir_dispatch_rejects_other_devices_and_impls():
    with pytest.raises(ValueError):
        kernel_or_plain("mps")
    with pytest.raises(ValueError):
        kernel_or_plain("cuda", impl="xla")


def test_fir_dispatch_sends_cpu_tensors_to_the_plain_versions():
    """On the CPU both dispatchers return their plain version's result and
    launch nothing."""
    p = torch.from_numpy(np.random.RandomState(0).randn(20, 21, 8).astype(np.float32))
    taps = hann_taps(4)
    mw, mh = (torch.from_numpy(banded(n, q, taps)) for n, q in ((18, 21), (17, 20)))
    before = dict(cuda_build.launches)
    torch.testing.assert_close(fir_taps(p, taps, taps), fir_taps_ref(p, taps, taps),
                               rtol=0, atol=0)
    torch.testing.assert_close(fir_banded(p, mw, mh), fir_banded_ref(p, mw, mh), rtol=0, atol=0)
    assert cuda_build.launches == before
    assert set(cuda_build.launches) == {"filtered_lrelu_fwd", "filtered_lrelu_bwd", "fir_taps",
                                        "fir_banded"}
    assert flrelu_cuda.launches is cuda_build.launches and fir_cuda.launches is cuda_build.launches


def _conv_calls():
    """Each conv path of the port on inputs that need gradients: the output
    and the leaves."""
    rng = np.random.RandomState(3)

    def leaf(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).requires_grad_()

    def modulated():
        x, w, s = leaf(2, 9, 10, 4), leaf(3, 3, 4, 5), leaf(2, 4)
        return modulated_conv2d(x, w, s, padding=1), [x, w, s]

    def alexnet():
        x = leaf(2, 9, 10, 4)
        conv = Conv2d(4, 6, 3, stride=2, padding=1, generator=torch.Generator().manual_seed(0))
        return conv(x), [x, conv.kernel, conv.bias]

    def fir():
        x = leaf(2, 9, 10, 4)
        return upfirdn2d(x, hann_taps(4), up=2, down=2, padding=3), [x]

    def modulated_up():
        """The StyleGAN2 up-conv: the transposed conv (`device.conv_transpose2d`)."""
        x, w, s = leaf(2, 5, 6, 4), leaf(3, 3, 4, 5), leaf(2, 4)
        return modulated_conv2d(x, w, s, padding=2, up=2), [x, w, s]

    def resample_up():
        """`conv2d_resample`'s transposed path, grouped."""
        from stylegan3_editing_tpu_torch.ops.conv2d_resample import conv2d_resample

        x, w = leaf(2, 6, 7, 4), leaf(3, 3, 2, 6)
        return conv2d_resample(x, w, f=hann_taps(4), up=2, padding=1, groups=2), [x, w]

    def fastgan():
        """FastGAN's init (a transposed conv of the 1×1 input) and its convs."""
        from stylegan3_editing_tpu_torch.models.fastgan import FastGANConfig, FastGANGenerator

        z = leaf(2, 8)
        net = FastGANGenerator(FastGANConfig(z_dim=8, img_resolution=16, ngf=8), device="cpu")
        return net(z), [z, net.init.weight]

    def mapper_step():
        """One StyleCLIP mapper step's loss on a slim decoder with a small
        CLIP and the 8-layer IR-SE trunk: the gradient to the mapper runs
        back through CLIP's patch conv and the IR-SE convs (inputs only: both
        nets are frozen)."""
        from stylegan3_editing_tpu_torch.editing.styleclip_mapper import (MapperCoach,
                                                                         MapperTrainOptions)
        from stylegan3_editing_tpu_torch.models.backbones.clip import CLIP
        from stylegan3_editing_tpu_torch.models.backbones.irse import IRSEBackbone

        cfg = sg3_r_config(32, channel_base=512, channel_max=16, num_layers=7)
        gen = torch.Generator().manual_seed(4)
        tokens = np.zeros((1, 77), np.int64)
        tokens[0, :3] = (49406, 320, 49407)
        coach = MapperCoach(
            MapperTrainOptions(stylegan_size=32), cfg,
            clip_model=CLIP(embed_dim=32, image_resolution=224, vision_width=64, vision_layers=1,
                            text_width=32, text_layers=1, text_heads=2, device="cpu",
                            generator=gen),
            facenet=IRSEBackbone(112, 8, "ir_se", generator=gen), text_tokens=tokens,
            device="cpu")
        w = torch.from_numpy(rng.randn(2, cfg.num_ws, 512).astype(np.float32))
        return coach.loss(w)[0], list(coach.net.mapper.parameters())

    def restyle_coach_step():
        """One ReStyle micro-step's loss on a slim decoder with every loss
        net of the coach (LPIPS, the ID loss on the 8-layer IR-SE trunk, MoCo's
        ResNet-50) and the 8-layer trunk in the encoder: the gradient to the
        encoder runs back through the loss nets' convs and its own."""
        import functools

        from stylegan3_editing_tpu_torch.criteria import id_loss
        from stylegan3_editing_tpu_torch.models.backbones.irse import IRSEBackbone
        from stylegan3_editing_tpu_torch.models.encoders import backbones, restyle
        from stylegan3_editing_tpu_torch.training import Coach, TrainOptions

        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(restyle.ENCODER_TYPES, "BackboneEncoder",
                       functools.partial(backbones.BackboneEncoder, num_layers=8))
            mp.setattr(id_loss, "IRSEBackbone", lambda input_size, num_layers, mode, **kw:
                       IRSEBackbone(input_size, 8, mode, **kw))
            coach = Coach(TrainOptions(n_iters_per_batch=2, lpips_lambda=0.8, l2_lambda=1,
                                       id_lambda=0.1, moco_lambda=0.5, output_size=32),
                          sg3_r_config(32, channel_base=512, channel_max=16, num_layers=4),
                          device="cpu")
        x = torch.from_numpy(np.tanh(rng.randn(1, 256, 256, 3)).astype(np.float32))
        outputs = coach._restyle_forward(x, train=True, stage=coach._current_stage())
        feats = coach._target_feats(x, x)
        loss = sum(coach._calc_loss(x, y_hat, latent, coach._current_stage(), feats)[0]
                   for y_hat, latent in outputs)
        return loss, [p for _, p in coach.trainable]

    def squeezenet():
        from stylegan3_editing_tpu_torch.models.backbones import SqueezeNetFeatures

        x = leaf(1, 35, 35, 3)
        net = SqueezeNetFeatures(generator=torch.Generator().manual_seed(0))
        return sum(f.square().mean() for f in net(x)), [x]

    def ms_ssim():
        from stylegan3_editing_tpu_torch.criteria import msssim

        a, b = leaf(1, 48, 48, 3), leaf(1, 48, 48, 3)
        return msssim(torch.tanh(a), torch.tanh(b), normalize="simple"), [a, b]

    def deit():
        from stylegan3_editing_tpu_torch.models.backbones.deit import DeiTTinyFeatures

        x = leaf(1, 224, 224, 3)
        net = DeiTTinyFeatures(generator=torch.Generator().manual_seed(0))
        return sum(f.square().mean() for f in net(x)), [x]

    def efficientnet():
        from stylegan3_editing_tpu_torch.models.backbones.efficientnet import (
            EfficientNetB0Features)

        x = leaf(1, 33, 34, 3)  # odd and even sides: the "SAME" pads differ
        net = EfficientNetB0Features(generator=torch.Generator().manual_seed(0))
        return sum(f.square().mean() for f in net(x)), [x]

    def set_discriminator():
        from stylegan3_editing_tpu_torch.setgan import ProjectedSetDiscriminator

        d = ProjectedSetDiscriminator(64, latent_size=16, num_discs=4, interp224=False,
                                      backbones=("tiny_proj",), attn_layers=1, device="cpu")
        r, x = leaf(1, 2, 64, 64, 3), leaf(1, 2, 64, 64, 3)
        return d(torch.tanh(r), torch.tanh(x)).sum(), [r, x]

    def inception():
        """InceptionV3 of the FID, its rectangular kernels included."""
        from stylegan3_editing_tpu_torch.models.backbones.inception import InceptionV3Features

        x = leaf(1, 40, 40, 3)
        net = InceptionV3Features(generator=torch.Generator().manual_seed(0))
        return net(torch.tanh(x)).square().mean(), [x]

    def mobilenet_v2():
        """A new registry family: depthwise convs (``groups``) and ReLU6."""
        from stylegan3_editing_tpu_torch.models.backbones.mobilenet import MobileNetV2Stages

        x = leaf(1, 32, 32, 3)
        net = MobileNetV2Stages(generator=torch.Generator().manual_seed(0))
        return sum(f.square().mean() for f in net(x)), [x]

    return {"modulated_conv2d_3x3": modulated, "alexnet_Conv2d": alexnet, "upfirdn2d": fir,
            "styleclip_mapper_step": mapper_step, "restyle_coach_step": restyle_coach_step,
            "squeezenet": squeezenet, "msssim": ms_ssim, "deit": deit,
            "efficientnet_b0": efficientnet, "set_discriminator": set_discriminator,
            "inception_v3": inception, "mobilenet_v2": mobilenet_v2,
            "modulated_conv2d_up2": modulated_up, "conv2d_resample_up": resample_up,
            "fastgan": fastgan}


@pytest.mark.parametrize("op", sorted(_conv_calls()))
def test_convs_run_without_tf32_and_restore_the_callers_flags(op):
    """Every cuDNN conv of the port, forward and backward, sees TF32 off and
    the caller's other cuDNN flags (``flags()`` would reset them to its
    defaults); the caller's TF32 setting (PyTorch's default: allowed) is
    back after the call and after ``backward()``. The backward counts too:
    autograd runs it inside the caller's ``backward()``, under the caller's
    flags, unless the port sets them there as well."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cudnn = torch.backends.cudnn
    aten = torch.ops.aten
    seen = []

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (aten.convolution.default, aten.convolution_backward.default):
                seen.append((func, (cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark,
                                    cudnn.deterministic)))
            return func(*args, **(kwargs or {}))

    flags = (True, True, True, True)
    with cudnn.flags(enabled=True, benchmark=True, deterministic=True, allow_tf32=True), \
            Recorder():
        out, leaves = _conv_calls()[op]()
        assert (cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark, cudnn.deterministic) == flags
        out.square().sum().backward()
        assert (cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark, cudnn.deterministic) == flags
    assert {f for f, _ in seen} == {aten.convolution.default, aten.convolution_backward.default}
    assert all(s == (False, True, True, True) for _, s in seen), seen
    assert torch.isfinite(out).all() and all(torch.isfinite(t.grad).all() for t in leaves)


@pytest.mark.parametrize("case", [
    dict(stride=1, padding=1, groups=1, bias=True),
    dict(stride=2, padding=(0, 2), groups=1, bias=False),
    dict(stride=(1, 2), padding=0, groups=4, bias=True),
    dict(stride=1, padding=2, dilation=2, groups=2, bias=False),
])
def test_conv2d_gradients_match_pytorchs(case):
    """`device.conv2d`'s own backward gives `F.conv2d`'s output and its
    gradients for x, the weight and the bias, in float64, to 1e-12; and it
    runs without a graph too (``no_grad``)."""
    from stylegan3_editing_tpu_torch.device import conv2d

    rng = np.random.RandomState(11)
    case = dict(case)
    groups, has_bias = case["groups"], case.pop("bias")
    x = torch.from_numpy(rng.randn(2, 8, 9, 11))
    w = torch.from_numpy(rng.randn(6 if groups == 2 else 8, 8 // groups, 3, 3))
    b = torch.from_numpy(rng.randn(w.shape[0])) if has_bias else None
    g = None
    grads = []
    for fn in (conv2d, torch.nn.functional.conv2d):
        leaves = [t.clone().requires_grad_() for t in (x, w, b) if t is not None]
        out = fn(*leaves[:2], leaves[2] if has_bias else None, **case)
        g = torch.from_numpy(rng.randn(*out.shape)) if g is None else g
        (out * g).sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-12, rtol=1e-12)
    with torch.no_grad():
        torch.testing.assert_close(conv2d(x, w, b, **case), grads[1][0], atol=1e-12, rtol=1e-12)


def test_library_key_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a local header a kernel includes changes its library's
    key, so no stale library is loaded; system headers are not followed."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setitem(cuda_build.KERNELS, "probe", cuda_build.Kernel(tmp_path / "k.cu", {}))
    assert [p.name for p in cuda_build.source_files(tmp_path / "k.cu")] == \
        ["k.cu", "a.cuh", "b.cuh"]
    before = cuda_build.library_path("probe")
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert cuda_build.library_path("probe") != before
    assert [p.name for p in cuda_build.source_files(cuda_build.KERNELS["fir_banded"].source)] \
        == ["fir_banded.cu", "mma.cuh"]


def test_version_libraries_are_keyed_by_their_own_source(tmp_path):
    """Another version of a kernel's source (as `build_versions` builds it)
    gets its own library key, from its text and the headers beside it; a
    copy of the registry's source and headers gets the registry's key."""
    src = cuda_build.KERNELS["filtered_lrelu_bwd"].source
    for path in cuda_build.source_files(src):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    copy = tmp_path / src.name
    assert cuda_build.library_path("filtered_lrelu_bwd", copy) == \
        cuda_build.library_path("filtered_lrelu_bwd")
    (tmp_path / "mma.cuh").write_text((tmp_path / "mma.cuh").read_text() + "// edit\n")
    assert cuda_build.library_path("filtered_lrelu_bwd", copy) != \
        cuda_build.library_path("filtered_lrelu_bwd")


def test_inference_modules_import_without_jax_pillow_sklearn_or_orbax():
    """The ReStyle, editing, checkpoint, data and CLI modules import with
    Pillow, scikit-learn and orbax unavailable (the card machine has none of
    them), and leave JAX unloaded; Pillow and scikit-learn load only where
    an image is read or written or a boundary is fitted."""
    code = ("import sys, json\n"
            "for name in ('PIL', 'sklearn', 'orbax', 'jax', 'flax'):\n"
            "    sys.modules[name] = None\n"
            "import stylegan3_editing_tpu_torch.models.encoders, "
            "stylegan3_editing_tpu_torch.models.backbones, "
            "stylegan3_editing_tpu_torch.models.sg3.convert, "
            "stylegan3_editing_tpu_torch.editing, stylegan3_editing_tpu_torch.runtime, "
            "stylegan3_editing_tpu_torch.training, stylegan3_editing_tpu_torch.data, "
            "stylegan3_editing_tpu_torch.configs, "
            "stylegan3_editing_tpu_torch.utils.inference_utils, "
            "stylegan3_editing_tpu_torch.utils.common, "
            "stylegan3_editing_tpu_torch.scripts.inference_iterative, "
            "stylegan3_editing_tpu_torch.scripts.inference_editing\n"
            "print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None "
            "and m.split('.')[0] in ('jax', 'flax', 'stylegan3_editing_tpu', 'PIL', "
            "'sklearn', 'orbax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_checkpoint_pti_and_fov_modules_import_without_jax_pillow_or_imageio():
    """The checkpoint readers, the two CLIs of reference checkpoints, the
    ResNet encoders and the interpolation and FOV helpers import with
    Pillow, imageio, scikit-learn and orbax unavailable (the card machine has
    none of them) and leave JAX unloaded."""
    code = ("import sys, json\n"
            "for name in ('PIL', 'imageio', 'sklearn', 'orbax', 'jax', 'flax'):\n"
            "    sys.modules[name] = None\n"
            "import stylegan3_editing_tpu_torch.models.sg3.persistence, "
            "stylegan3_editing_tpu_torch.models.sg3.convert, "
            "stylegan3_editing_tpu_torch.models.backbones.resnet, "
            "stylegan3_editing_tpu_torch.scripts.convert_checkpoint, "
            "stylegan3_editing_tpu_torch.scripts.run_pti_images, "
            "stylegan3_editing_tpu_torch.utils.gen_utils, "
            "stylegan3_editing_tpu_torch.utils.fov_expansion\n"
            "print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None "
            "and m.split('.')[0] in ('jax', 'flax', 'stylegan3_editing_tpu', 'PIL', "
            "'imageio', 'sklearn', 'orbax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_clip_convs_and_matmuls_run_in_full_fp32():
    """CLIP's patch conv and every matmul of its image and text encoders see
    TF32 off (cuDNN's flag, and matmul precision "highest") while the caller
    allows TF32 for both, and the caller's settings come back after each
    call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from stylegan3_editing_tpu_torch.models.backbones.clip import CLIP

    cudnn, aten = torch.backends.cudnn, torch.ops.aten
    matmuls = {aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default}
    seen = []

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in matmuls or func is aten.convolution.default:
                seen.append((func, torch.get_float32_matmul_precision(), cudnn.allow_tf32))
            return func(*args, **(kwargs or {}))

    model = CLIP(embed_dim=32, image_resolution=64, vision_width=64, vision_layers=1,
                 text_width=32, text_layers=1, text_heads=2, device="cpu")
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with cudnn.flags(enabled=True, allow_tf32=True), Recorder(), torch.no_grad():
            img = model.encode_image(torch.zeros((2, 64, 64, 3)))
            assert (torch.get_float32_matmul_precision(), cudnn.allow_tf32) == ("high", True)
            txt = model.encode_text(np.ones((2, 77), np.int32))
            assert (torch.get_float32_matmul_precision(), cudnn.allow_tf32) == ("high", True)
    finally:
        torch.set_float32_matmul_precision(before)
    assert img.shape == txt.shape == (2, 32)
    ops = {f for f, _, _ in seen}
    assert aten.convolution.default in ops and ops & matmuls, ops
    assert all(not tf32 for f, _, tf32 in seen if f is aten.convolution.default), seen
    assert all(p == "highest" for f, p, _ in seen if f in matmuls), seen


def test_styleclip_and_video_modules_import_without_optional_packages():
    """The CLIP, StyleCLIP, alignment and video modules and their four CLIs
    import with Pillow, imageio, cv2, dlib, regex, scikit-learn and orbax
    unavailable (the card machine has none of them) and leave JAX unloaded;
    they load where a frame is read, aligned or written."""
    blocked = ("PIL", "imageio", "cv2", "dlib", "regex", "sklearn", "orbax", "jax", "flax")
    code = ("import sys, json\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import stylegan3_editing_tpu_torch.models.backbones.clip, "
            "stylegan3_editing_tpu_torch.editing.styleclip_global, "
            "stylegan3_editing_tpu_torch.utils.alignment_utils, "
            "stylegan3_editing_tpu_torch.video.video_config, "
            "stylegan3_editing_tpu_torch.video.video_handler, "
            "stylegan3_editing_tpu_torch.video.post_processing, "
            "stylegan3_editing_tpu_torch.video.video_editor, "
            "stylegan3_editing_tpu_torch.scripts.styleclip_preprocess, "
            "stylegan3_editing_tpu_torch.scripts.styleclip_edit, "
            "stylegan3_editing_tpu_torch.scripts.inference_on_video, "
            "stylegan3_editing_tpu_torch.scripts.compute_landmarks_transforms\n"
            "print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None "
            f"and m.split('.')[0] in {blocked + ('stylegan3_editing_tpu',)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("entry", ["clip", "styleclip_preprocess", "styleclip_edit",
                                   "inference_on_video"])
def test_styleclip_and_video_entry_points_raise_without_a_card(monkeypatch, entry, tmp_path):
    """CLIP and the CLIs that run on the card raise without one unless they
    are given ``device="cpu"``: nothing carries on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from stylegan3_editing_tpu_torch.models.backbones.clip import CLIP
    from stylegan3_editing_tpu_torch.scripts import (inference_on_video, styleclip_edit,
                                                     styleclip_preprocess)

    call = {"clip": lambda: CLIP(vision_layers=1, text_layers=1),
            "styleclip_preprocess": lambda: styleclip_preprocess.main(
                ["--output_path", str(tmp_path)]),
            "styleclip_edit": lambda: styleclip_edit.main(["--exp_dir", str(tmp_path)]),
            "inference_on_video": lambda: inference_on_video.main(
                ["--output_path", str(tmp_path)])}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_training_side_modules_import_without_optional_packages():
    """The scorers, the mapper and its losses, Ranger, MTCNN and the three
    CLIs of this side (`train_boundaries`, `prepare_faces_parallel`,
    `calc_id_loss_parallel`) import with Pillow, cv2, dlib, scikit-learn and
    orbax unavailable (the card machine has none of them) and leave JAX
    unloaded."""
    blocked = ("PIL", "imageio", "cv2", "dlib", "regex", "sklearn", "orbax", "jax", "flax")
    code = ("import sys, json\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import stylegan3_editing_tpu_torch.editing.attribute_scorers, "
            "stylegan3_editing_tpu_torch.editing.styleclip_mapper, "
            "stylegan3_editing_tpu_torch.criteria, "
            "stylegan3_editing_tpu_torch.training.ranger, "
            "stylegan3_editing_tpu_torch.models.mtcnn, "
            "stylegan3_editing_tpu_torch.models.backbones.vgg, "
            "stylegan3_editing_tpu_torch.scripts.train_boundaries, "
            "stylegan3_editing_tpu_torch.scripts.prepare_faces_parallel, "
            "stylegan3_editing_tpu_torch.scripts.calc_id_loss_parallel\n"
            "print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None "
            f"and m.split('.')[0] in {blocked + ('stylegan3_editing_tpu',)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("entry", ["age", "pose", "attributes", "mapper_coach", "mtcnn",
                                   "train_boundaries", "calc_id_loss_parallel"])
def test_training_side_entry_points_raise_without_a_card(monkeypatch, entry, tmp_path):
    """The scorers, the mapper's coach, MTCNN and the two CLIs that run on
    the card raise without one unless they are given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from stylegan3_editing_tpu_torch.editing import attribute_scorers as sc
    from stylegan3_editing_tpu_torch.editing.styleclip_mapper import (MapperCoach,
                                                                     MapperTrainOptions)
    from stylegan3_editing_tpu_torch.models.mtcnn import MTCNN
    from stylegan3_editing_tpu_torch.scripts import calc_id_loss_parallel, train_boundaries

    cfg = sg3_r_config(32, channel_base=512, channel_max=16, num_layers=7)
    call = {"age": sc.AgeEstimator, "pose": sc.PoseEstimator,
            "attributes": sc.AttributeClassifier,
            "mapper_coach": lambda: MapperCoach(MapperTrainOptions(), cfg,
                                                text_tokens=np.zeros((1, 77), np.int64)),
            "mtcnn": MTCNN,
            "train_boundaries": lambda: train_boundaries.main(["--output_dir", str(tmp_path)]),
            "calc_id_loss_parallel": lambda: calc_id_loss_parallel.main(
                ["--output_path", str(tmp_path)])}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_restyle_training_modules_import_without_optional_packages():
    """The ReStyle coach, its criteria, discriminator, runtime modules
    (events, profiling, statistics), prefetcher, training helpers and both
    training CLIs import with Pillow, cv2, dlib, scikit-learn and orbax
    unavailable (the card machine has none of them) and leave JAX unloaded."""
    blocked = ("PIL", "imageio", "cv2", "dlib", "regex", "sklearn", "orbax", "jax", "flax")
    code = ("import sys, json\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import stylegan3_editing_tpu_torch.training.coach, "
            "stylegan3_editing_tpu_torch.training.latent_discriminator, "
            "stylegan3_editing_tpu_torch.criteria.moco_loss, "
            "stylegan3_editing_tpu_torch.criteria.w_norm, "
            "stylegan3_editing_tpu_torch.runtime.events, "
            "stylegan3_editing_tpu_torch.runtime.profiling, "
            "stylegan3_editing_tpu_torch.runtime.training_stats, "
            "stylegan3_editing_tpu_torch.data.prefetch, "
            "stylegan3_editing_tpu_torch.utils.train_utils, "
            "stylegan3_editing_tpu_torch.configs, "
            "stylegan3_editing_tpu_torch.scripts.train_restyle_psp, "
            "stylegan3_editing_tpu_torch.scripts.train_restyle_e4e\n"
            "print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None "
            f"and m.split('.')[0] in {blocked + ('stylegan3_editing_tpu',)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("entry", ["coach", "e4e_coach", "train_restyle_psp",
                                   "train_restyle_e4e", "moco_loss"])
def test_restyle_training_entry_points_raise_without_a_card(monkeypatch, entry, tmp_path):
    """The coach (pSp and e4e), MoCo's loss and both training CLIs raise
    without a card unless they are given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from PIL import Image

    from stylegan3_editing_tpu_torch.criteria import MocoLoss
    from stylegan3_editing_tpu_torch.scripts import train_restyle_e4e, train_restyle_psp
    from stylegan3_editing_tpu_torch.training import Coach, E4eTrainOptions, TrainOptions
    from stylegan3_editing_tpu_torch.utils.cli import parse_dataclass

    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "face.png")
    cfg = sg3_r_config(32, channel_base=512, channel_max=16, num_layers=4)
    args = ["--train_root", str(tmp_path), "--exp_dir", str(tmp_path / "exp"),
            "--output_size", "32", "--decoder_channel_base", "512",
            "--decoder_channel_max", "16", "--decoder_num_layers", "4"]
    call = {"coach": lambda: Coach(TrainOptions(output_size=32), cfg),
            "e4e_coach": lambda: Coach(E4eTrainOptions(output_size=32,
                                                       w_discriminator_lambda=0.1), cfg),
            "train_restyle_psp": lambda: train_restyle_psp.main(
                parse_dataclass(train_restyle_psp.PspCliOptions, args)),
            "train_restyle_e4e": lambda: train_restyle_e4e.main(
                parse_dataclass(train_restyle_e4e.E4eCliOptions, args)),
            "moco_loss": MocoLoss}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_evaluation_and_setgan_modules_import_without_optional_packages():
    """LPIPS' trunks, MS-SSIM, the three evaluation CLIs and SetGAN's set
    transformer, generator and data sampler import with JAX, Pillow,
    imageio, scipy and scikit-learn unavailable (the card machine lacks
    the first three) and leave JAX unloaded."""
    blocked = ("PIL", "imageio", "scipy", "sklearn", "cv2", "orbax", "jax", "flax")
    code = ("import sys, json\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import stylegan3_editing_tpu_torch.criteria.ms_ssim, "
            "stylegan3_editing_tpu_torch.criteria.lpips, "
            "stylegan3_editing_tpu_torch.models.backbones.squeezenet, "
            "stylegan3_editing_tpu_torch.models.backbones.vgg, "
            "stylegan3_editing_tpu_torch.scripts.calc_losses_on_images, "
            "stylegan3_editing_tpu_torch.scripts.create_inversion_animation, "
            "stylegan3_editing_tpu_torch.scripts.eval_inversion_fidelity, "
            "stylegan3_editing_tpu_torch.setgan, "
            "stylegan3_editing_tpu_torch.setgan.set_transformer, "
            "stylegan3_editing_tpu_torch.setgan.model, "
            "stylegan3_editing_tpu_torch.setgan.dataset\n"
            "print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None "
            f"and m.split('.')[0] in {blocked + ('stylegan3_editing_tpu',)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("entry", ["calc_losses_on_images", "create_inversion_animation",
                                   "eval_inversion_fidelity", "setgan", "lpips_squeeze"])
def test_evaluation_and_setgan_entry_points_raise_without_a_card(monkeypatch, entry, tmp_path):
    """The three evaluation CLIs, `SetGAN` and LPIPS raise without a card
    unless they are given ``device="cpu"``; the CLIs before they read a file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from stylegan3_editing_tpu_torch.criteria import LPIPS
    from stylegan3_editing_tpu_torch.scripts import (calc_losses_on_images,
                                                     create_inversion_animation,
                                                     eval_inversion_fidelity)
    from stylegan3_editing_tpu_torch.setgan import SetGAN

    call = {"calc_losses_on_images": lambda: calc_losses_on_images.main(
                ["--output_path", str(tmp_path), "--gt_path", str(tmp_path)]),
            "create_inversion_animation": lambda: create_inversion_animation.main(
                ["--exp_dir", str(tmp_path / "exp"), "--latents_path", str(tmp_path / "no.npy")]),
            "eval_inversion_fidelity": lambda: eval_inversion_fidelity.main(
                ["--reference_root", str(tmp_path)]),
            "setgan": lambda: SetGAN(sg3_r_config(32, channel_base=512, channel_max=16,
                                                  num_layers=4), encoder_num_layers=8),
            "lpips_squeeze": lambda: LPIPS("squeeze")}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_setgan_training_modules_import_without_optional_packages():
    """The feature-network registry and its DeiT and EfficientNet families,
    DiffAugment, ADA, the loss, the discriminator, the trainer, the runtime
    utilities and the training CLI import with JAX, Pillow, scipy and
    scikit-learn unavailable and leave JAX unloaded."""
    blocked = ("PIL", "imageio", "scipy", "sklearn", "cv2", "orbax", "jax", "flax")
    code = ("import sys, json\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import stylegan3_editing_tpu_torch.models.backbones.registry, "
            "stylegan3_editing_tpu_torch.models.backbones.deit, "
            "stylegan3_editing_tpu_torch.models.backbones.efficientnet, "
            "stylegan3_editing_tpu_torch.setgan.diffaugment, "
            "stylegan3_editing_tpu_torch.setgan.ada, "
            "stylegan3_editing_tpu_torch.setgan.loss, "
            "stylegan3_editing_tpu_torch.setgan.discriminator, "
            "stylegan3_editing_tpu_torch.setgan.training_loop, "
            "stylegan3_editing_tpu_torch.runtime.util, "
            "stylegan3_editing_tpu_torch.scripts.train_setgan\n"
            "print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None "
            f"and m.split('.')[0] in {blocked + ('stylegan3_editing_tpu',)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_stems_and_growth_modules_import_without_optional_packages():
    """The other stems, the rosinality StyleGAN2, `conv2d_resample`, the
    superres growth and the native preprocessor import with JAX, Pillow and
    scipy unavailable and leave JAX unloaded."""
    blocked = ("PIL", "imageio", "scipy", "sklearn", "cv2", "orbax", "jax", "flax")
    code = ("import sys, json\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import stylegan3_editing_tpu_torch.models.sg2_stem, "
            "stylegan3_editing_tpu_torch.models.fastgan, "
            "stylegan3_editing_tpu_torch.models.stylegan2, "
            "stylegan3_editing_tpu_torch.models.sg3.superres, "
            "stylegan3_editing_tpu_torch.ops.conv2d_resample, "
            "stylegan3_editing_tpu_torch.data.native, "
            "stylegan3_editing_tpu_torch.scripts.convert_checkpoint\n"
            "print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None "
            f"and m.split('.')[0] in {blocked + ('stylegan3_editing_tpu',)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("entry", ["sg2_stem", "fastgan", "stylegan2_g", "stylegan2_d"])
def test_stems_raise_without_a_card(monkeypatch, entry):
    """The new generators and the discriminator are built on the card unless
    ``device="cpu"``: without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from stylegan3_editing_tpu_torch.models import fastgan, sg2_stem, stylegan2

    call = {"sg2_stem": lambda: sg2_stem.SG2Generator(sg2_stem.SG2Config(img_resolution=8)),
            "fastgan": lambda: fastgan.FastGANGenerator(fastgan.FastGANConfig(img_resolution=8)),
            "stylegan2_g": lambda: stylegan2.SG2Generator(size=8, style_dim=8, n_mlp=1),
            "stylegan2_d": lambda: stylegan2.SG2Discriminator(size=8)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call[entry]()


@pytest.mark.parametrize("entry", ["train_setgan", "trainer", "discriminator"])
def test_setgan_training_entry_points_raise_without_a_card(monkeypatch, entry, tmp_path):
    """`train_setgan` (before it reads its data), `SetGANTrainer` and the
    discriminator raise without a card unless they are given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from stylegan3_editing_tpu_torch.scripts import train_setgan
    from stylegan3_editing_tpu_torch.setgan import (ProjectedSetDiscriminator,
                                                    SetGANTrainConfig, SetGANTrainer)

    call = {"train_setgan": lambda: train_setgan.cli(
                ["--data", str(tmp_path / "none"), "--outdir", str(tmp_path / "out"),
                 "--fid", "false"]),
            "trainer": lambda: SetGANTrainer(
                SetGANTrainConfig(d_backbones=("tiny_proj",), encoder_num_layers=8),
                sg3_r_config(32, channel_base=512, channel_max=16, num_layers=4)),
            "discriminator": lambda: ProjectedSetDiscriminator(32, backbones=("tiny_proj",))}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call[entry]()
    assert not (tmp_path / "out").exists()


def test_fused_filtered_lrelu_backward_is_once_differentiable(monkeypatch):
    """The backward kernel's dx carries no graph, so a double backward through
    `FusedFilteredLrelu` must raise rather than drop the second-order terms.
    On the CPU the kernels are stood in for by their plain versions."""
    import importlib

    fl = importlib.import_module("stylegan3_editing_tpu_torch.ops.filtered_lrelu")
    s = next(s for s in build_synthesis_layout(sg3_t_config(64, channel_base=1024,
                                                            channel_max=32)).layers
             if s.up_filter is not None)
    monkeypatch.setattr(fl.flrelu_cuda, "filtered_lrelu_cuda",
                        lambda x, fu, fd, b, up, padding, gain, slope, clamp:
                        fl.filtered_lrelu_ref(x, fu, fd, b, up, 2, padding, gain, slope, clamp))
    monkeypatch.setattr(fl.flrelu_cuda, "filtered_lrelu_bwd_cuda",
                        lambda dy, x, fu, fd, b, up, padding, gain, slope, clamp:
                        fl.filtered_lrelu_bwd_ref(dy, x, fu, fd, b, up, padding, gain, slope,
                                                  clamp))
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, s.in_size[1], s.in_size[0], 4).astype(np.float32))
    b = torch.from_numpy(rng.randn(4).astype(np.float32))
    x.requires_grad_(True)
    y = fl.FusedFilteredLrelu.apply(x, b, s.up_filter, s.down_filter, s.up_factor, s.padding,
                                    math.sqrt(2), 0.2, s.conv_clamp)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()


def test_fid_and_new_backbone_modules_import_without_optional_packages():
    """InceptionV3, the conditional FID, the spectrum and the registry's
    DenseNet, MobileNet, ShuffleNet, RegNet and CLIP-RN50 modules import with
    JAX, Pillow and scipy (which `frechet_distance` takes when it runs)
    unavailable and leave JAX unloaded."""
    blocked = ("PIL", "imageio", "scipy", "sklearn", "cv2", "orbax", "jax", "flax")
    code = ("import sys, json\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import stylegan3_editing_tpu_torch.models.backbones.inception, "
            "stylegan3_editing_tpu_torch.models.backbones.densenet, "
            "stylegan3_editing_tpu_torch.models.backbones.mobilenet, "
            "stylegan3_editing_tpu_torch.models.backbones.shufflenet, "
            "stylegan3_editing_tpu_torch.models.backbones.regnet, "
            "stylegan3_editing_tpu_torch.models.backbones.clip_resnet, "
            "stylegan3_editing_tpu_torch.setgan.metrics, "
            "stylegan3_editing_tpu_torch.utils.spectrum\n"
            "print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None "
            f"and m.split('.')[0] in {blocked + ('stylegan3_editing_tpu',)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("entry", ["inception_feature_fn", "make_fid_eval_fn"])
def test_fid_entry_points_raise_without_a_card(monkeypatch, entry):
    """The FID's feature extractor and the CLI's evaluation raise without a
    card unless they are given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from stylegan3_editing_tpu_torch.models.backbones.inception import inception_feature_fn
    from stylegan3_editing_tpu_torch.scripts import train_setgan

    call = {"inception_feature_fn": lambda: inception_feature_fn(),
            "make_fid_eval_fn": lambda: train_setgan.make_fid_eval_fn(
                train_setgan.SetGANCliOptions(), dataset=None)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.mark.parametrize("what", ["sync_across_hosts", "compute", "one_rank"])
def test_fid_sync_refuses_more_than_one_rank(monkeypatch, what):
    """Under a process group of more than one rank the FID's moments would
    need a cross-rank sum: `sync_across_hosts` and `ConditionalFID.compute`
    raise instead of giving a local answer. A group of one rank is local."""
    import torch.distributed as dist

    from stylegan3_editing_tpu_torch.setgan.metrics import ConditionalFID, FeatureStats

    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 1 if what == "one_rank" else 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 0)
    feats = np.random.RandomState(0).randn(4, 3)
    st = FeatureStats()
    st.append(feats)
    fid = ConditionalFID(lambda x: x)
    fid.append_real(0, feats)
    fid.append_fake(0, feats + 1)
    if what == "one_rank":
        assert st.sync_across_hosts() is st and np.isfinite(fid.compute("agg"))
        return
    with pytest.raises(NotImplementedError, match="#10"):
        st.sync_across_hosts() if what == "sync_across_hosts" else fid.compute("agg")
