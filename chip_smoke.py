#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
1. device: the card's name and power limit;
2. build: compiles the filtered-lrelu kernel from the repository's source
   and prints ptxas' registers and shared memory;
3. per layer: the kernel against the plain PyTorch version on each of the
   14 filtered-lrelu layers of SG3-R 1024 at full size, batch 1, in the
   layer's dtype (bf16 layers against the plain version in fp32 on the
   upcast input);
4. full width: `Generator(sg3_r_config(1024))` with seeded random weights,
   truncation 0.7, batch 8: shape, finiteness, 14 kernel launches per
   forward, and at batch 1 an fp32 forward through the kernels against the
   same forward with ``impl="ref"``;
5. timing with CUDA events after warm-up: images/s at batch 8, each layer's
   kernel, plain and bound times at batch 8, and peak memory.

TF32 is off for matmuls and cuDNN convs. The second-to-last line is the
kernel table as JSON; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
FP32_TOL = (1e-4, 1e-4)    # (atol, rtol): sum order of fp32 taps and cuDNN
BF16_TOL = (1e-3, 2 ** -8)  # one bf16 rounding of the kernel's fp32 result
IMAGE_TOL = 1e-3           # fp32 image, kernel vs plain: sum order over 15 layers


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
    """(bytes, flops) the fused op needs: the input read and the output
    written once; the up pass's tu/up non-zero taps per up-grid point per
    axis, lrelu·gain·clamp (3 per up-grid point), and the down pass's td²
    (2-D fd) or 2·td (separable, two passes) taps per output, 2 FLOPs a tap,
    over the up grid the output needs."""
    n, h, _, c = x_shape
    _, oh, ow, _ = out_shape
    span_h, span_w = 2 * oh + td - 2, 2 * ow + td - 2
    taps_u = tu // up
    up_flops = 2 * taps_u * (h * span_w + span_h * span_w) + 3 * span_h * span_w
    down_flops = 2 * (td * td * oh * ow if radial else td * span_h * ow + td * oh * ow)
    nbytes = esize * (math.prod(x_shape) + math.prod(out_shape))
    return nbytes, n * c * (up_flops + down_flops)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from stylegan3_editing_tpu_torch.models.sg3 import (
        Generator, build_synthesis_layout, sg3_r_config)
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda
    from stylegan3_editing_tpu_torch.ops.filtered_lrelu import filtered_lrelu

    # 1. Device.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}")
    print(smi)
    card = f"[{smi}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN")
    dev = torch.device("cuda")

    # 2. Build.
    t0 = time.perf_counter()
    lib = flrelu_cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {' '.join(flrelu_cuda.NVCC_FLAGS)})")
    for line in flrelu_cuda.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())
    for up in (2, 4):
        print(f"  dynamic shared memory per block, up {up}: "
              f"{lib.sg3_flrelu_fwd_smem_bytes(up)} B")

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
        main_launches = flrelu_cuda.launches
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
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
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
            nbytes, flops = flrelu_work(
                tuple(x.shape), tuple(out.shape), s.up_factor, len(s.up_filter),
                s.down_filter.shape[0], s.down_filter.ndim == 2, x.element_size())
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
            k_ms = time_ms(lambda: kernel_call(s, x, b), 10)

            def plain_batch():
                for n in range(x.shape[0]):
                    layer_call(s, x[n:n + 1], b, impl="ref")

            p_ms = time_ms(plain_batch, 3, warmup=1)
            bound = max(bytes_ms, ops_ms)
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound),
                           ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                tot[key] += v
            print(f"time {s.name} {str(x.dtype)[6:]} batch 8: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({'operations' if ops_ms > bytes_ms else 'bytes'}: "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) {card}")
            del x, b, out
            torch.cuda.empty_cache()
        print(f"time all 14 layers batch 8: kernel {tot['ms']:.4f} ms, plain "
              f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms {card}")

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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
