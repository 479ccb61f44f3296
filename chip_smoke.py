#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
1. device: the card's name and power limit;
2. build: compiles all four kernels (filtered-lrelu forward and backward,
   the probe's tap chains and banded products) from the repository's
   sources, in parallel, and prints ptxas' registers, each kernel's shared
   memory per block and the tensor-core instructions in the SASS of the
   forward kernel (its down pass on bf16 radial layers), of the backward
   kernel (its dy up pass on bf16 radial layers) and of the banded kernel,
   and the two probe kernels' resident blocks per SM at [76, 76, 16896];
   it fails if one of the three has no bf16 tensor-core instruction, or if
   fewer than two blocks of a probe kernel share an SM;
3. per layer: the kernel against the plain PyTorch version on each of the
   14 filtered-lrelu layers of SG3-R 1024 at full size, batch 1, in the
   layer's dtype (bf16 layers against the plain version in fp32 on the
   upcast input);
4. full width: `Generator(sg3_r_config(1024))` with seeded random weights,
   truncation 0.7, batch 8: shape, finiteness, 14 kernel launches per
   forward, and at batch 1 an fp32 forward through the kernels against the
   same forward with ``impl="ref"``;
5. timing with CUDA events after warm-up: images/s at batch 8, and peak
   memory; each layer's kernel, plain and bound times at batch 8, with the
   route of its down pass (tensor cores on bf16 radial layers, L5-L11, CUDA
   cores elsewhere) and two bounds: every FLOP at the fp32 rate, and the
   tensor-core route's useful down-pass FLOPs at the bf16 tensor-core rate;
6. backward per layer: the backward kernel against `filtered_lrelu_bwd_ref`
   on each of the 14 layers at full size, batch 1, in the layer's dtype with
   a seeded dy (dx, and db = Σ dx); and the plain backward against
   `torch.autograd.grad` of the plain forward on 3 layers at reduced size;
7. PTI at full width: `PTI` on the same generator with LPIPS-alex from a
   seeded init; targets are the images of ws (z from seed 1), pivots
   ws + 0.3·noise. Shared mode at batch 4 for 10 steps, per-image mode on 2
   images for 5 steps: 14 forward and 14 backward launches per image-pass,
   finite losses, shared-mode L2 falling; then one fp32 step at batch 1
   through the kernels against the same step with ``impl="ref"``, gradient
   of every trainable tensor;
8. timing: one whole call each of `PTI.optimize_shared` (batch 4) and
   `PTI.optimize_batch` (2 images, final render included) for 5 steps, as
   s/step and s per image-step with peak memory; and each layer's backward
   kernel, plain and bound times at batch 4, with the route of its dy up
   pass (tensor cores on bf16 radial layers, L5-L11, CUDA cores elsewhere)
   and two bounds: every FLOP at the fp32 rate, and the tensor-core route's
   useful dy-up FLOPs (36 taps per up-grid point) at the bf16 tensor-core
   rate;
9. the banded-FIR probe: its entry point at its defaults in fp32 and bf16
   (launch counts, outputs against the plain versions, the bf16 error
   between the two forms against that of their plain versions); then each
   probe kernel against its plain version at [76, 76, 128] and
   [76, 76, 16896] in both dtypes, timed beside its plain version, its
   library call (TF32 off) and its bound.

PyTorch's TF32 flags stay at their defaults: matmuls run in fp32 by
default, and the port holds its cuDNN convs to fp32 itself (`device.conv2d`;
phase 9's library conv goes through it too). The second-to-last line is the
kernel table as JSON; the last line is ``{"ok": true, "device": ...}``.
Times carry the card's name and power limit.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
TC_FLOPS = 989e12          # H100 SXM dense bf16 on the tensor cores
FP32_TOL = (1e-4, 1e-4)    # (atol, rtol): sum order of fp32 taps and cuDNN
BF16_TOL = (1e-3, 2 ** -8)  # one bf16 rounding of the kernel's fp32 result
IMAGE_TOL = 1e-3           # fp32 image, kernel vs plain: sum order over 15 layers
DB_TOL = {False: 1e-4, True: 2 ** -6}  # db (by bf16 layer), of max |db|: dx's rounding, summed
AUTOGRAD_TOL = (1e-4, 1e-4)  # plain backward vs autograd of the plain forward (fp32)
GRAD_TOL = 1e-3            # fp32 PTI step, kernels vs impl="ref", of each tensor's max |grad|
FIR_TOL = 1e-5             # probe kernels vs plain, of max |ref|: sum order, split tf32 ~2^-22
FIR_SHAPES = [(76, 76, 128), (76, 76, 16896)]  # the TPU probe's plane; 132 x 128 channels
FIR_TAPS = 12
FLRELU = {"filtered_lrelu_fwd": 0, "filtered_lrelu_bwd": 0}
NO_FIR = {"fir_taps": 0, "fir_banded": 0}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flrelu_work(x_shape, out_shape, up: int, tu: int, td: int, radial: bool,
                esize: int):
    """(bytes, up_flops, down_flops) the fused op needs: the input read and
    the output written once; the up pass's tu/up non-zero taps per up-grid
    point per axis and lrelu·gain·clamp (3 per up-grid point), then the down
    pass's td² (2-D fd) or 2·td (separable, two passes) taps per output, 2
    FLOPs a tap, over the up grid the output needs. The down pass counts its
    useful taps only, not the zeros of the tensor-core route's padded W."""
    n, h, _, c = x_shape
    _, oh, ow, _ = out_shape
    span_h, span_w = 2 * oh + td - 2, 2 * ow + td - 2
    taps_u = tu // up
    up_flops = 2 * taps_u * (h * span_w + span_h * span_w) + 3 * span_h * span_w
    down_flops = 2 * (td * td * oh * ow if radial else td * span_h * ow + td * oh * ow)
    nbytes = esize * (math.prod(x_shape) + math.prod(out_shape))
    return nbytes, n * c * up_flops, n * c * down_flops


def flrelu_bwd_work(x_shape, dy_shape, up: int, tu: int, td: int, radial: bool,
                    esize: int):
    """(bytes, dy_up_flops, other_flops) the fused backward needs: dy and x
    read and dx written once; on the backward up grid (x_len·up + tu − up per
    axis) the dy up pass (36 real taps per point for the 12×12 radial fd, or
    two passes of td/2 taps), and the rest: the A recompute (the forward's
    up-pass count), 3 per point for the mask, and the stride-up down pass
    (tu taps per dx sample per axis), 2 FLOPs a tap. The dy up pass counts
    its useful taps only, not the zeros of the tensor-core route's W."""
    n, xh, xw, c = x_shape
    _, yh, _, _ = dy_shape
    gh, gw = xh * up + tu - up, xw * up + tu - up
    half = td // 2
    dy_up = 2 * half * half * gh * gw if radial else 2 * half * (yh * gw + gh * gw)
    a_up = 2 * (tu // up) * (xh * gw + gh * gw)
    down = 2 * tu * (gh * xw + xh * xw)
    nbytes = esize * (2 * math.prod(x_shape) + math.prod(dy_shape))
    return nbytes, n * c * dy_up, n * c * (a_up + 3 * gh * gw + down)


def fir_work(shape, taps: int, esize: int, matrices: bool):
    """(bytes, flops) of the probe's FIR on a [Qh, Qw, C] plane: the plane
    read and the fp32 output written once, plus the inputs that shape the
    filter (the banded matrices in p's dtype, or the fp32 taps of both axes);
    the useful FLOPs, 2 per tap: the W chain on all Qh rows, then the H chain
    per output."""
    qh, qw, c = shape
    i, j = qh - taps + 1, qw - taps + 1
    shaping = esize * (j * qw + i * qh) if matrices else 4 * 2 * taps
    nbytes = esize * qh * qw * c + 4 * i * j * c + shaping
    return nbytes, 2 * taps * (qh * j + i * j) * c


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from stylegan3_editing_tpu_torch.criteria import LPIPS
    from stylegan3_editing_tpu_torch.device import conv2d
    from stylegan3_editing_tpu_torch.inversion import PTI, PTIOptions
    from stylegan3_editing_tpu_torch.models.sg3 import (
        Generator, build_synthesis_layout, sg3_r_config)
    from stylegan3_editing_tpu_torch.ops import cuda_build, fir_cuda, flrelu_cuda
    from stylegan3_editing_tpu_torch.ops.banded_fir import (banded, fir_banded_ref,
                                                            fir_taps_ref, hann_taps)
    from stylegan3_editing_tpu_torch.scripts import exp_mxu_down as probe
    from stylegan3_editing_tpu_torch.ops.filtered_lrelu import (
        filtered_lrelu, filtered_lrelu_bwd_ref)

    # 1. Device.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}")
    print(smi)
    card = f"[{smi}]"
    print(f"PyTorch's TF32 flags left at their defaults (matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}): "
          f"the port holds its cuDNN convs to fp32 itself (device.conv2d)")
    dev = torch.device("cuda")

    # 2. Build.
    t0 = time.perf_counter()
    libs = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(libs)} kernels in parallel "
          f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for name, log in cuda_build.build_log.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())
    bwd_smem = libs["filtered_lrelu_bwd"].sg3_flrelu_bwd_smem_bytes
    for up in (2, 4):
        print(f"  dynamic shared memory per block, up {up}: forward "
              f"{libs['filtered_lrelu_fwd'].sg3_flrelu_fwd_smem_bytes(up)} B, backward "
              f"{bwd_smem(up, 1, 1)} B (radial fd, bf16: tensor-core dy up pass), "
              f"{bwd_smem(up, 1, 0)} B (radial fd, fp32), {bwd_smem(up, 0, 0)} B (separable)")
    qh, qw, c = FIR_SHAPES[1]
    fir_out = (qh - FIR_TAPS + 1, qw - FIR_TAPS + 1)
    taps_lib, banded_lib = libs["fir_taps"], libs["fir_banded"]
    taps_args = (qh, qw, c, FIR_TAPS, FIR_TAPS)
    taps_blocks = [taps_lib.sg3_fir_taps_blocks_per_sm(*taps_args, dt) for dt in (0, 1)]
    banded_blocks = [banded_lib.sg3_fir_banded_blocks_per_sm(qh, qw, *fir_out[::-1], dt)
                     for dt in (0, 1)]
    print(f"  dynamic shared memory per block, probe {FIR_TAPS} taps, [{qh}, {qw}, {c}] -> "
          f"{list(fir_out)}: fir_taps {taps_lib.sg3_fir_taps_smem_bytes(*taps_args, 0)} B "
          f"(fp32), {taps_lib.sg3_fir_taps_smem_bytes(*taps_args, 1)} B (bf16); fir_banded "
          f"{banded_lib.sg3_fir_banded_smem_bytes(qh, qw, *fir_out[::-1], 0)} B (fp32), "
          f"{banded_lib.sg3_fir_banded_smem_bytes(qh, qw, *fir_out[::-1], 1)} B (bf16); "
          f"blocks per SM: fir_taps {taps_blocks[0]} (fp32), {taps_blocks[1]} (bf16), "
          f"fir_banded {banded_blocks[0]} (fp32), {banded_blocks[1]} (bf16)")
    for name, blocks in (("fir_taps", taps_blocks), ("fir_banded", banded_blocks)):
        if min(blocks) < 2:
            raise SystemExit(f"{name} keeps fewer than 2 blocks per SM at the probe's shape")
    for name in ("filtered_lrelu_fwd", "filtered_lrelu_bwd", "fir_banded"):
        hmma = cuda_build.sass_mma_counts(name)
        print(f"  sass {name}: tensor-core instructions {dict(hmma)} (mma.sync)"
              if hmma is not None else f"  sass {name}: cuobjdump not found, HMMA not counted")
        if hmma is not None and not any(op.endswith(".BF16") for op in hmma):
            raise SystemExit(f"{name} issues no bf16 tensor-core instruction")

    cfg = sg3_r_config(1024)
    layers = [s for s in build_synthesis_layout(cfg).layers if s.up_filter is not None]
    assert len(layers) == 14

    def layer_call(s, x, b, impl="auto"):
        return filtered_lrelu(x, fu=s.up_filter, fd=s.down_filter, b=b, up=s.up_factor,
                              down=s.down_factor, padding=s.padding, clamp=s.conv_clamp,
                              impl=impl)

    def kernel_call(s, x, b):
        return flrelu_cuda.filtered_lrelu_cuda(
            x, s.up_filter, s.down_filter, b, s.up_factor, s.padding,
            gain=math.sqrt(2), slope=0.2, clamp=s.conv_clamp)

    def layer_inputs(s, batch, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        dtype = torch.bfloat16 if s.use_bf16 else torch.float32
        x = torch.randn((batch, s.in_size[1], s.in_size[0], s.out_channels),
                        generator=gen, device=dev).to(dtype)
        b = torch.randn((s.out_channels,), generator=gen, device=dev).to(dtype)
        return x, b

    # 3. Per layer: kernel vs plain at full size, batch 1.
    max_err = 0.0
    with torch.inference_mode():
        for i, s in enumerate(layers):
            x, b = layer_inputs(s, 1, seed=i)
            got = kernel_call(s, x, b).float()
            ref = layer_call(s, x.float(), b.float(), impl="ref")
            torch.cuda.synchronize()
            atol, rtol = BF16_TOL if s.use_bf16 else FP32_TOL
            err = (got - ref).abs()
            ok = bool((err <= atol + rtol * ref.abs()).all()) and got.shape == ref.shape
            max_err = max(max_err, float(err.max()))
            print(f"check {s.name} {str(x.dtype)[6:]} in {tuple(x.shape)} out "
                  f"{tuple(got.shape)}: max abs err {float(err.max()):.3e} "
                  f"(tol atol {atol:g} + rtol {rtol:g}·|ref|, max |ref| "
                  f"{float(ref.abs().max()):.3g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"kernel disagrees with the plain version on {s.name}")
            del x, b, got, ref, err
    torch.cuda.empty_cache()

    # 4. Full width, batch 8: the main path.
    G = Generator(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    z = torch.randn((8, cfg.z_dim), generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        flrelu_cuda.reset_launches()
        img = G(z, truncation_psi=0.7)
        torch.cuda.synchronize()
        main_launches = flrelu_cuda.launches["filtered_lrelu_fwd"]
        print(f"main path: image {tuple(img.shape)} {img.dtype}, kernel launches "
              f"{main_launches} per forward")
        if tuple(img.shape) != (8, 1024, 1024, 3) or img.dtype != torch.float32:
            raise SystemExit("wrong image shape or dtype")
        if not bool(torch.isfinite(img).all()):
            raise SystemExit("non-finite image values")
        if main_launches != len(layers):
            raise SystemExit(f"expected {len(layers)} kernel launches, saw {main_launches}")

        a = G(z[:1], truncation_psi=0.7, force_fp32=True)
        r = G(z[:1], truncation_psi=0.7, force_fp32=True, impl="ref")
        img_err = float((a - r).abs().max())
        print(f"fp32 image, kernels vs impl='ref', batch 1: max abs err {img_err:.3e} "
              f"(tol {IMAGE_TOL:g}, max |ref| {float(r.abs().max()):.3g})")
        if not img_err <= IMAGE_TOL:
            raise SystemExit("fp32 image through the kernels disagrees with impl='ref'")
        del a, r

        # 5. Timing.
        iters = 5
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = time_ms(lambda: G(z, truncation_psi=0.7), iters, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        print(f"throughput: {8 * 1000 / fwd_ms:.4f} img/s at batch 8 "
              f"({fwd_ms:.3f} ms per forward) {card}")
        print(f"peak memory: {peak / 2 ** 30:.3f} GiB at batch 8 {card}")

        # Per layer at the main path's batch of 8. The plain version runs one
        # image per call: at batch 8 its x`up` intermediate passes 2^31
        # elements on the top layers. Images 0 and 7 of the kernel's batch-8
        # output are held against it as in phase 3.
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, fp32_bound_ms=0.0, bytes_ms=0.0,
                   ops_ms=0.0)
        for i, s in enumerate(layers):
            x, b = layer_inputs(s, 8, seed=100 + i)
            out = kernel_call(s, x, b)
            atol, rtol = BF16_TOL if s.use_bf16 else FP32_TOL
            for n in (0, 7):
                ref = layer_call(s, x[n:n + 1].float(), b.float(), impl="ref")
                err = (out[n:n + 1].float() - ref).abs()
                max_err = max(max_err, float(err.max()))
                if not bool((err <= atol + rtol * ref.abs()).all()):
                    raise SystemExit(f"kernel disagrees with the plain version on "
                                     f"{s.name}, batch 8, image {n}")
                del ref, err
            nbytes, up_flops, down_flops = flrelu_work(
                tuple(x.shape), tuple(out.shape), s.up_factor, len(s.up_filter),
                s.down_filter.shape[0], s.down_filter.ndim == 2, x.element_size())
            tensor_cores = flrelu_cuda.mma_down(x.dtype, s.down_filter)
            flops = up_flops + down_flops
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            fp32_ops_ms = flops / FP32_FLOPS * 1e3
            ops_ms = (up_flops / FP32_FLOPS + down_flops / TC_FLOPS) * 1e3 if tensor_cores \
                else fp32_ops_ms
            k_ms = time_ms(lambda: kernel_call(s, x, b), 10)

            def plain_batch():
                for n in range(x.shape[0]):
                    layer_call(s, x[n:n + 1], b, impl="ref")

            p_ms = time_ms(plain_batch, 3, warmup=1)
            bound, fp32_bound = max(bytes_ms, ops_ms), max(bytes_ms, fp32_ops_ms)
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound),
                           ("fp32_bound_ms", fp32_bound), ("bytes_ms", bytes_ms),
                           ("ops_ms", ops_ms)):
                tot[key] += v
            print(f"time {s.name} {str(x.dtype)[6:]} batch 8, down pass on the "
                  f"{'tensor cores' if tensor_cores else 'CUDA cores'}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({'operations' if ops_ms > bytes_ms else 'bytes'}: "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP of which down pass "
                  f"{down_flops / 1e9:.2f}), all-fp32 bound {fp32_bound:.4f} ms {card}")
            del x, b, out
            torch.cuda.empty_cache()
        print(f"time all 14 layers batch 8: kernel {tot['ms']:.4f} ms, plain "
              f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, all-fp32 bound "
              f"{tot['fp32_bound_ms']:.4f} ms {card}")

    # 6. Backward per layer: kernel vs plain at full size, batch 1.
    def bwd_kernel_call(s, dy, x, b):
        return flrelu_cuda.filtered_lrelu_bwd_cuda(
            dy, x, s.up_filter, s.down_filter, b, s.up_factor, s.padding,
            gain=math.sqrt(2), slope=0.2, clamp=s.conv_clamp)

    def bwd_plain_call(s, dy, x, b):
        return filtered_lrelu_bwd_ref(dy, x, s.up_filter, s.down_filter, b, s.up_factor,
                                      s.padding, clamp=s.conv_clamp)

    def bwd_inputs(s, batch, seed):
        """x scaled by 60 so that the clamp of 256 bites on some up-grid points."""
        x, b = layer_inputs(s, batch, seed)
        x = (x.float() * 60).to(x.dtype)
        gen = torch.Generator(device=dev).manual_seed(seed + 1000)
        dy = torch.randn((batch, s.out_size[1], s.out_size[0], s.out_channels),
                         generator=gen, device=dev).to(x.dtype)
        return dy, x, b

    def check_bwd(s, dx, dy, x, b, what):
        ref = bwd_plain_call(s, dy.float(), x.float(), b.float())
        torch.cuda.synchronize()
        atol, rtol = BF16_TOL if s.use_bf16 else FP32_TOL
        err = (dx.float() - ref).abs()
        ok = bool((err <= atol + rtol * ref.abs()).all()) and dx.shape == ref.shape
        db, db_ref = dx.float().sum((0, 1, 2)), ref.sum((0, 1, 2))
        db_err = float((db - db_ref).abs().max())
        db_tol = DB_TOL[s.use_bf16] * float(db_ref.abs().max())
        ok = ok and db_err <= db_tol
        if not ok:
            raise SystemExit(f"backward kernel disagrees with the plain version on {what}: "
                             f"dx err {float(err.max()):.3e}, db err {db_err:.3e} "
                             f"(tol {db_tol:.3e})")
        return float(err.max()), float(ref.abs().max()), db_err, db_tol

    bwd_max_err = 0.0
    with torch.no_grad():
        for i, s in enumerate(layers):
            dy, x, b = bwd_inputs(s, 1, seed=200 + i)
            dx = bwd_kernel_call(s, dy, x, b)
            err, ref_max, db_err, db_tol = check_bwd(s, dx, dy, x, b, s.name)
            bwd_max_err = max(bwd_max_err, err)
            atol, rtol = BF16_TOL if s.use_bf16 else FP32_TOL
            print(f"check bwd {s.name} {str(x.dtype)[6:]} dy {tuple(dy.shape)} dx "
                  f"{tuple(dx.shape)}: max abs err {err:.3e} (tol atol {atol:g} + rtol "
                  f"{rtol:g}·|ref|, max |ref| {ref_max:.3g}); db max abs err {db_err:.3e} "
                  f"(tol {db_tol:.3e}) ok")
            del dy, x, b, dx
        torch.cuda.empty_cache()
    # The plain backward against autograd of the plain forward, fp32, reduced size.
    for s in (layers[2], layers[11], layers[13]):
        gen = torch.Generator(device=dev).manual_seed(7)
        side = max(s.in_size[1] // 4, 40)
        x = torch.randn((1, side, side, min(s.out_channels, 32)), generator=gen, device=dev) * 60
        b = torch.randn((x.shape[-1],), generator=gen, device=dev)
        xg, bg = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = layer_call(s, xg, bg, impl="ref")
        dy = torch.randn(y.shape, generator=gen, device=dev)
        gx, gb = torch.autograd.grad(y, (xg, bg), dy)
        dx = bwd_plain_call(s, dy, x, b)
        atol, rtol = AUTOGRAD_TOL
        ok = bool(((dx - gx).abs() <= atol + rtol * gx.abs()).all())
        db_err = float((dx.sum((0, 1, 2)) - gb).abs().max())
        ok = ok and db_err <= DB_TOL[False] * float(gb.abs().max())
        print(f"check plain bwd vs autograd {s.name} x {tuple(x.shape)}: max abs err "
              f"{float((dx - gx).abs().max()):.3e} (tol atol {atol:g} + rtol {rtol:g}·|ref|), "
              f"db {db_err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"filtered_lrelu_bwd_ref disagrees with autograd on {s.name}")
        del x, b, xg, bg, y, dy, gx, gb, dx

    # 7. PTI at full width: the training path through both kernels.
    lpips = LPIPS("alex", device=dev, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws = G.map(torch.randn((4, cfg.z_dim), generator=torch.Generator().manual_seed(1)).to(dev))
        targets = G.synthesize(ws)
    pivot = ws + 0.3 * torch.randn(ws.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    pti = PTI(G, lpips, PTIOptions(lpips_threshold=0.0))
    shared_steps, batch_steps = 10, 5
    flrelu_cuda.reset_launches()
    _, history = pti.optimize_shared(lambda: [(pivot, targets, None)], steps=shared_steps)
    torch.cuda.synchronize()
    shared_launches = dict(flrelu_cuda.launches)
    print(f"PTI shared mode, batch 4, {shared_steps} steps: l2 {history[0]['l2']:.6f} -> "
          f"{history[-1]['l2']:.6f}, lpips {history[0]['lpips']:.6f} -> "
          f"{history[-1]['lpips']:.6f}; launches {shared_launches}")
    if shared_launches != {"filtered_lrelu_fwd": 14 * shared_steps,
                           "filtered_lrelu_bwd": 14 * shared_steps, **NO_FIR}:
        raise SystemExit("expected 14 forward and 14 backward launches per PTI step")
    if not all(math.isfinite(h[k]) for h in history for k in ("loss", "l2", "lpips")):
        raise SystemExit("non-finite PTI loss")
    if not history[-1]["l2"] < history[0]["l2"]:
        raise SystemExit("shared-mode PTI did not lower the L2 loss")
    flrelu_cuda.reset_launches()
    stacked, imgs, metrics = pti.optimize_batch(pivot[:2], targets[:2], steps=batch_steps)
    torch.cuda.synchronize()
    batch_launches = dict(flrelu_cuda.launches)
    print(f"PTI per-image mode, 2 images, {batch_steps} steps: loss "
          f"{metrics['loss'].tolist()}, l2 {metrics['l2'].tolist()}; launches {batch_launches} "
          f"(plus 14 forward launches per image for the final render)")
    passes = 2 * batch_steps
    if batch_launches != {"filtered_lrelu_fwd": 14 * (passes + 2),
                          "filtered_lrelu_bwd": 14 * passes, **NO_FIR}:
        raise SystemExit("expected 14 forward and 14 backward launches per image-pass")
    if not (bool(torch.isfinite(imgs).all()) and tuple(imgs.shape) == (2, 1024, 1024, 3)
            and all(bool(torch.isfinite(v).all()) for v in metrics.values())):
        raise SystemExit("non-finite per-image PTI result")
    del stacked, imgs
    # One fp32 step at batch 1: kernels vs impl="ref", every trainable tensor.
    pti.force_fp32 = True
    params = pti.initial_params()
    grads = {impl: pti.loss_and_grads(params, pivot[:1], targets[:1], impl=impl)[2]
             for impl in ("auto", "ref")}
    pti.force_fp32 = False
    worst = max((float((grads["auto"][k] - g).abs().max()) / float(g.abs().max()), k)
                for k, g in grads["ref"].items() if float(g.abs().max()) > 0)
    print(f"PTI fp32 step, batch 1, kernels vs impl='ref': {len(grads['ref'])} trainable "
          f"tensors, worst max abs err / max |grad| {worst[0]:.3e} on {worst[1]} "
          f"(tol {GRAD_TOL:g})")
    if not worst[0] <= GRAD_TOL:
        raise SystemExit("PTI gradients through the kernels disagree with impl='ref'")
    del grads, params
    torch.cuda.empty_cache()

    # 8. Timing: whole calls of the PTI entry points (phase 7 was their warm-up),
    # then the backward kernel per layer at batch 4. The per-image call's time
    # includes its final render (one forward per image).
    timed_steps = 5
    for mode, call, n_img in (
            ("shared, batch 4",
             lambda: pti.optimize_shared(lambda: [(pivot, targets, None)], steps=timed_steps), 4),
            ("per image, 2 images",
             lambda: pti.optimize_batch(pivot[:2], targets[:2], steps=timed_steps), 2)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"PTI step time, {mode}, {timed_steps} steps: {secs / timed_steps:.4f} s per "
              f"step, {secs / (timed_steps * n_img):.4f} s per image-step, peak memory "
              f"{peak:.3f} GiB {card}")
        del result
    torch.cuda.empty_cache()

    btot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, fp32_bound_ms=0.0, bytes_ms=0.0,
                ops_ms=0.0)
    with torch.no_grad():
        for i, s in enumerate(layers):
            dy, x, b = bwd_inputs(s, 4, seed=300 + i)
            dx = bwd_kernel_call(s, dy, x, b)
            for n in (0, 3):
                err = check_bwd(s, dx[n:n + 1], dy[n:n + 1], x[n:n + 1], b,
                                f"{s.name}, batch 4, image {n}")[0]
                bwd_max_err = max(bwd_max_err, err)
            nbytes, dy_up_flops, other_flops = flrelu_bwd_work(
                tuple(x.shape), tuple(dy.shape), s.up_factor, len(s.up_filter),
                s.down_filter.shape[0], s.down_filter.ndim == 2, x.element_size())
            tensor_cores = flrelu_cuda.mma_up(x.dtype, s.down_filter)
            flops = dy_up_flops + other_flops
            bytes_ms, fp32_ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
            ops_ms = (other_flops / FP32_FLOPS + dy_up_flops / TC_FLOPS) * 1e3 if tensor_cores \
                else fp32_ops_ms
            k_ms = time_ms(lambda: bwd_kernel_call(s, dy, x, b), 10)

            def plain_batch():
                for n in range(x.shape[0]):
                    bwd_plain_call(s, dy[n:n + 1], x[n:n + 1], b)

            p_ms = time_ms(plain_batch, 2, warmup=1)
            bound, fp32_bound = max(bytes_ms, ops_ms), max(bytes_ms, fp32_ops_ms)
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound),
                           ("fp32_bound_ms", fp32_bound), ("bytes_ms", bytes_ms),
                           ("ops_ms", ops_ms)):
                btot[key] += v
            print(f"time bwd {s.name} {str(x.dtype)[6:]} batch 4, dy up pass on the "
                  f"{'tensor cores' if tensor_cores else 'CUDA cores'}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({'operations' if ops_ms > bytes_ms else 'bytes'}: "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP of which dy up pass "
                  f"{dy_up_flops / 1e9:.2f}), all-fp32 bound {fp32_bound:.4f} ms {card}")
            del dy, x, b, dx
            torch.cuda.empty_cache()
    print(f"time bwd all 14 layers batch 4: kernel {btot['ms']:.4f} ms, plain "
          f"{btot['plain_ms']:.4f} ms, bound {btot['bound_ms']:.4f} ms, all-fp32 bound "
          f"{btot['fp32_bound_ms']:.4f} ms {card}")

    # 9. The banded-FIR probe: its entry point at its defaults, in fp32 and
    # bf16, is the path that launches the probe kernels.
    probe_iters = 32

    def fir_tol_ok(err, ref):
        return err <= FIR_TOL * float(ref.abs().max())

    cuda_build.reset_launches()
    probe_out = {dt: probe.main(["--dtype", dt, "--iters", str(probe_iters)])
                 for dt in ("f32", "bf16")}
    torch.cuda.synchronize()
    probe_launches = dict(cuda_build.launches)
    # Per kernel: both dtypes, each one checked call, the warm-up and the timed calls.
    calls = 2 * (1 + probe.WARMUP + probe_iters)
    print(f"probe entry point, f32 and bf16, {probe_iters} timed calls each: launches "
          f"{probe_launches}")
    if probe_launches != {**FLRELU, "fir_taps": calls, "fir_banded": calls}:
        raise SystemExit(f"expected {calls} launches of each probe kernel")
    qh, qw, c = FIR_SHAPES[0]
    taps = hann_taps(FIR_TAPS)
    rel = {}
    for dt, (y_vpu, y_mxu) in probe_out.items():
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        p = torch.randn((qh, qw, c), generator=torch.Generator().manual_seed(0)).to(dev, dtype)
        mw = torch.from_numpy(banded(qw - FIR_TAPS + 1, qw, taps)).to(dev, dtype)
        mh = torch.from_numpy(banded(qh - FIR_TAPS + 1, qh, taps)).to(dev, dtype)
        r_vpu, r_mxu = fir_taps_ref(p, taps, taps), fir_banded_ref(p, mw, mh)
        for name, got, ref in (("vpu-chain", y_vpu, r_vpu), ("mxu-dot", y_mxu, r_mxu)):
            err = float((got - ref).abs().max())
            ok = (tuple(got.shape) == tuple(ref.shape) == (qh - FIR_TAPS + 1, qw - FIR_TAPS + 1, c)
                  and got.dtype == torch.float32 and bool(torch.isfinite(got).all())
                  and fir_tol_ok(err, ref))
            print(f"check probe {dt} {name} {tuple(got.shape)}: max abs err {err:.3e} against "
                  f"the plain version (tol {FIR_TOL:g}·max |ref|, max |ref| "
                  f"{float(ref.abs().max()):.3g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"probe {name} output disagrees with its plain version")
        rel[dt] = [float((a - b).abs().max()) / (float(a.abs().max()) + 1e-9)
                   for a, b in ((y_vpu, y_mxu), (r_vpu, r_mxu))]
        print(f"probe {dt} rel err vpu vs mxu: kernels {rel[dt][0]:.3e}, plain versions "
              f"{rel[dt][1]:.3e}")
    if not (rel["f32"][0] <= FIR_TOL and 0.5 <= rel["bf16"][0] / rel["bf16"][1] <= 2):
        raise SystemExit("probe rel err vpu vs mxu is off: fp32 above the tolerance, or bf16 "
                         "not within 2x of the plain versions' (the taps' bf16 rounding)")

    # Each probe kernel against its plain version, timed beside it, its
    # library call and its bound. Inputs from a seeded generator on the card.
    def fir_calls(p, mw, mh, w2d):
        return {
            "fir_taps": (lambda: fir_cuda.fir_taps_cuda(p, taps, taps),
                         lambda: fir_taps_ref(p, taps, taps),
                         lambda: conv2d(p.float().permute(2, 0, 1).unsqueeze(0), w2d,
                                        groups=p.shape[2])),
            "fir_banded": (lambda: fir_cuda.fir_banded_cuda(p, mw, mh),
                           lambda: fir_banded_ref(p, mw, mh),
                           lambda: torch.einsum("iq,jp,qpc->ijc", mh.float(), mw.float(),
                                                p.float())),
        }

    fir_rows = {}
    with torch.inference_mode():
        for shape in FIR_SHAPES:
            qh, qw, c = shape
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device=dev).manual_seed(400 + c)
                p = torch.randn(shape, generator=gen, device=dev).to(dtype)
                mw = torch.from_numpy(banded(qw - FIR_TAPS + 1, qw, taps)).to(dev, dtype)
                mh = torch.from_numpy(banded(qh - FIR_TAPS + 1, qh, taps)).to(dev, dtype)
                w2d = torch.from_numpy(np.outer(taps, taps)).to(dev)
                w2d = w2d.expand(c, 1, -1, -1).contiguous()
                for name, (kern, plain, library) in fir_calls(p, mw, mh, w2d).items():
                    got, ref = kern(), plain()
                    lib_out = library()
                    if name == "fir_taps":
                        lib_out = lib_out[0].permute(1, 2, 0)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    lib_err = float((lib_out - ref).abs().max())
                    if not (got.shape == ref.shape and fir_tol_ok(err, ref)):
                        raise SystemExit(f"{name} disagrees with its plain version at {shape} "
                                         f"{dtype}: max abs err {err:.3e}")
                    nbytes, flops = fir_work(shape, FIR_TAPS, p.element_size(),
                                             name == "fir_banded")
                    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
                    row = dict(max_abs_err=err, ms=time_ms(kern, 20), plain_ms=time_ms(plain, 5),
                               library_ms=time_ms(library, 5), bound_ms=max(bytes_ms, ops_ms),
                               bound_by="operations" if ops_ms > bytes_ms else "bytes")
                    fir_rows[name, shape, dtype] = row
                    print(f"time {name} {list(shape)} {str(dtype)[6:]}: kernel {row['ms']:.4f} ms, "
                          f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
                          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
                          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); max abs err "
                          f"{err:.3e} (tol {FIR_TOL:g}·max |ref| {float(ref.abs().max()):.3g}), "
                          f"library vs plain {lib_err:.3e} {card}")
                    del got, ref, lib_out
                del p, mw, mh, w2d
                torch.cuda.empty_cache()

    def fir_entry(name, replaces):
        row = fir_rows[name, FIR_SHAPES[1], torch.bfloat16]
        return {"name": name, "route": "cuda",
                "source": f"stylegan3_editing_tpu_torch/ops/csrc/{name}.cu",
                "replaces": replaces, "launches": probe_launches[name], **row}

    print(json.dumps({"kernels": [{
        "name": "filtered_lrelu_fwd",
        "route": "cuda",
        "source": "stylegan3_editing_tpu_torch/ops/csrc/filtered_lrelu_fwd.cu",
        "replaces": "stylegan3_editing_tpu/ops/pallas_flrelu.py:565",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
        "library_ms": None,
    }, {
        "name": "filtered_lrelu_bwd",
        "route": "cuda",
        "source": "stylegan3_editing_tpu_torch/ops/csrc/filtered_lrelu_bwd.cu",
        "replaces": "stylegan3_editing_tpu/ops/pallas_flrelu.py:1023 (_flrelu_bwd_kernel) "
                    "and :1017 (_flrelu_bwd_kernel_mxu)",
        "launches": shared_launches["filtered_lrelu_bwd"] // shared_steps,
        "max_abs_err": bwd_max_err,
        "ms": btot["ms"],
        "plain_ms": btot["plain_ms"],
        "bound_ms": btot["bound_ms"],
        "bound_by": "operations" if btot["ops_ms"] > btot["bytes_ms"] else "bytes",
        "library_ms": None,
    }, fir_entry("fir_taps", "scripts/exp_mxu_down.py:56"),
        fir_entry("fir_banded", "scripts/exp_mxu_down.py:47")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
