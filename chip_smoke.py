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
   library call (TF32 off) and its bound;
10. ReStyle inversion and InterFaceGAN editing at full width:
   `RestyleNet(sg3_r_config(1024), ...)` with the e4e and the pSp encoder
   (IR-SE-50 at 256², 6 input channels, 16 styles), seeded random weights
   with non-trivial batch-norm statistics and a decoder ``w_avg`` from 256
   mapped z. Two seeded faces: `get_average_image`, then
   `run_restyle_iterations(n_iters=3)` without and with a landmarks
   transform (each decode one launch per layer; the dual decode is one
   call at batch 4): shapes, finiteness, 14 launches per decode call; the
   loop at batch 2 with the transform (every decode the dual one at batch
   4) in fp32 through the kernels against ``impl="ref"`` (every image
   within `IMAGE_TOL`, the codes within `RESTYLE_CODES_TOL`); `FaceEditor`
   over factors -5..5 with three seeded unit directions (22 images a call,
   bf16 route): 14 launches a call, and the factor-0 renders against
   ``decoder.synthesize`` within `RANGE_RENDER_TOL`, which the neighbouring
   factors' renders and the pair swapped must exceed; timing of the
   encoders, the loop (s per batch) and the edit call (ms, images/s) with
   the peak memory of each, and one `torch.profiler` trace of each loop
   and of an edit call (device busy and idle share, kernel #1's launches
   and device time, the encoder's and decoder's host and device time);
   then kernel #1 at each batch the path gives it (fp32 route at 2 and 4,
   each layer's dtype at 22): images 0 and batch - 1 against the plain
   version, and its time alone beside its bound;
11. reference checkpoints on the card, no JAX: (a) a seeded SG3-R 1024
   generator written in the reference's naming as a ``.pt`` state dict and
   as an official-format pickle (nested `persistent_class` objects whose
   embedded source raises if it is ever run), each converted by
   `scripts.convert_checkpoint` (``--kind auto``) and loaded into a fresh
   `Generator`: every leaf equal, the fp32 image through the kernels equal
   to the source's to 0, the conversion's seconds; (b)
   `scripts.run_pti_images.tune` from the pickle's ``.npz`` (phase 7's
   targets and pivots): per image on 2 images and shared at batch 4, 5 steps
   each, 14 forward and 14 backward launches per image-pass, finite losses,
   and a tree written by the CLI's writer renders its image within
   `IMAGE_TOL`; s per image-step, s/step, peak memory; (c) ReStyle pSp and
   e4e on the ResNet-34 trunk from a reference-format state dict (seeded,
   non-trivial batch norms, 16 styles) through `convert_checkpoint
   --kind encoder` and `load_encoder` with the (a) decoder: the loop at
   batch 2 with the dual decode through the kernels against ``impl="ref"``
   (`IMAGE_TOL`, `RESTYLE_CODES_TOL`), 14 launches per decode call; the
   encoders' ms beside phase 10's IR-SE-50, the loop's s per batch, peak
   memory; (d) `Expander` on one face, 256 pixels each side: 9 views in one
   synthesize (bf16 route), the 1536² canvas, 14 launches, the centre
   against a batch-1 render within the generator tests' bf16 image
   tolerance, which the unshifted left view must exceed; ms per expanded
   image and peak memory; then kernel #1 at that batch of 9 (each layer's
   dtype) against its plain version and timed beside its bound;
12. StyleCLIP global directions and the video pipeline at full width, seeded
   weights (SG3-R 1024 with its zero leaves seeded, CLIP ViT-B/32): (a)
   `compute_s_statistics` at the CLI's defaults (100,000 z, batch 1024, psi
   0.5, cutoff 8), its seconds, and its mean and std against a float64
   two-pass recomputation on the card from the same samples
   (`STATS_STD_TOL`); (b) `delta_i_c_batch` on the first batch of five
   groups (`DELTA_GROUPS`), ms per channel and the full S's estimate, 14
   launches a batch, one batch through the kernels against ``impl="ref"``
   (`DELTA_COS_TOL`, which the +/- renders swapped must miss), and CLIP's
   image features on the card against the CPU (`CLIP_TOL`); (c) a StyleCLIP
   edit at batch 2 (a BPE vocabulary the script writes, a seeded
   ``delta_i_c``): launches, the fp32 route through the kernels against
   ``impl="ref"`` within `IMAGE_TOL`, which the unedited render must
   exceed, the bf16 route's kernel and plain renders against the fp32 one,
   ms, images/s, peak memory; (d) the video path on tensors: 12 frames of 256^2 with
   seeded per-frame transforms, ReStyle e4e at batch 4 x 3 iterations with
   the landmarks transforms, `postprocess_and_smooth_inversions` with 256
   pixels a side, `InterFaceGANVideoEditor` at -2 and +2 with its smoothed
   renders, `StyleCLIPVideoEditor`: launch counts, shapes, ms per frame of
   each stage, peak memory; then kernel #1 at each new batch of the path
   (16, 12, 9 in each layer's dtype, 8 in the fp32 route, 2) against its
   plain version and timed beside its bound;
13. the editing side's training at full width, seeded weights: (a)
   `scripts.train_boundaries` up to the scores: 256 z at psi 0.7,
   pseudo-aligned, each scorer (age on VGG16, pose_yaw on ResNet-50, Smiling
   on the attribute head) on 4 batches of 8 bf16 renders at 1024^2 resized
   to 224^2: 14 launches a batch, finite scores, one batch's scores card vs
   CPU (`SCORER_TOL`), ms per sample and the CLI's 10,000-sample estimate
   (the SVM fit needs scikit-learn, which the card's machine lacks); (b)
   `MapperCoach` on SG3-R 1024 (LevelsMapper, CLIP ViT-B/32 at its
   published widths, IR-SE-50, tokens of "a face with a smile" from a BPE
   vocabulary the script writes) at the default lambdas, lr 0.5, Ranger,
   batch 2, 12 steps: 28 forward and 14 backward launches a step, finite
   losses, no gradient in the frozen networks; one step at batch 1 through
   the kernels against ``impl="ref"`` (`MAPPER_LOSS_TOL`, each mapper
   gradient within `GRAD_TOL` of its max); s/step, peak memory and one
   traced step (#1, #2, the decoder, CLIP and IR-SE-50 on the device, the
   idle share); (c) kernel #2's fp32 route at batch 2 on the 14 layers
   against `filtered_lrelu_bwd_ref` (images 0 and 1), timed beside its plain
   version and two bounds (all at the fp32 rate; the radial layers' dy up
   pass at the tensor-core rate); (d) MTCNN's P-Net on a 1024^2 image's
   scale pyramid and its R- and O-Nets at batch 64, and
   `calc_id_loss_parallel`'s IR-101 at batch 4, card vs CPU within
   `FP32_TOL` (detect and align resize with Pillow, which the card's machine
   lacks; they run in the CPU tests);
14. ReStyle encoder training at full width, seeded weights: (a) `Coach.train`
   for pSp at the upstream README's FFHQ command (SG3-R 1024, IR-SE-50 at
   256^2, batch 2, 3 iterations, LPIPS 0.8 / L2 1 / ID 0.1, Ranger lr 1e-4,
   an effective batch of 8) for 8 micro-steps, a validation batch at 4 and
   a checkpoint at 8 (no image grids: no Pillow there): 42 + 42 launches
   every micro-step, the encoder moving at micro-steps 4 and 8 only and its
   batch-norm statistics at every one, no gradient in the decoder or the
   loss nets, the checkpoint through `load_encoder` giving the coach's codes
   to 0; s per micro-step and per optimizer step, peak memory, and one traced
   micro-step with Ranger's step (the idle share; #1's and #2's device time;
   the encoder's, IR-SE-50's, LPIPS' and Ranger's host and device time);
   (b) e4e at `scripts/train_e4e.sh`'s recipe (ResNet-34 progressive, 256^2,
   w-disc 0.1, pools of 50, psi 0.7) with ``progressive_steps=[0, 2, 4]``
   for 6 micro-steps, R1 every 4: the discriminator's, R1's and the delta
   losses finite, the stage advancing, 14 + 14 launches a decode, s per
   micro-step; (c) one pSp micro-step at batch 1 through the kernels
   against ``impl="ref"`` (the plain decodes recomputed in the backward):
   the losses within `MAPPER_LOSS_TOL`, every encoder gradient within
   `GRAD_TOL` of the gradient's largest |entry|;
15. the evaluation side and SetGAN's generator at full width, seeded
   weights: (a) LPIPS on the AlexNet, VGG16 and SqueezeNet trunks and
   MS-SSIM on a batch of 8 at 256^2, the card against the CPU within
   `EVAL_TOL` of max |ref|, ms per image; `calc_losses_on_images`' metric in
   its three modes over 2 x 16 pairs (card vs CPU); `create_inversion_animation`'s
   render loop from a numpy-format e4e checkpoint (IR-SE-50, SG3-R 1024)
   through `load_encoder`: 3 latents with landmarks transforms, 2 x 25
   frames in chunks of 8, 14 launches a chunk, ms per frame, peak memory,
   and kernel #1 at batch 1 in each layer's dtype; `eval_inversion_fidelity`'s
   port half at its defaults (SG3-R 1024 fp32, IR-SE-50 e4e from a
   reference-format state, 4 targets, 3 iterations): 14 launches a decode,
   s per run, LPIPS of the reconstructions; (b) `SetGAN` at
   `scripts/train_setgan_stem.sh`'s recipe at 256^2 (SG3-T, channel base
   16384, max 256, 7 layers; IR-SE-50 e4e encoder; batch 16, references 4-7
   of 7, candidates 1-4 of 4, no mean-centring, 4 heads, 2 attention
   layers), its sets drawn by `ImageMultiSetGenerator` from seeded renders
   held in memory: one forward as the trainer's G step makes it (encoder in
   eval, no grad), 7 launches a call, ms per call, candidate images/s, peak
   memory, one traced call (idle share; the encoder's, StyleAttention's and
   the decoder's host and device time); kernel #1 on SG3-T 256's layers at
   batch 64 against its plain version, timed beside it and its bound, and
   at batch 1; gates: the fp32 forward at batch 2 through the kernels
   against ``impl="ref"`` within `IMAGE_TOL`, padded reference slots filled
   with another image within `PAD_TOL` (which unmasking them must exceed),
   the sampler's batch again from its seed; then the pretrained recipe's
   ReStyle-encoder mode (1 iteration, mean-centred): 14 launches, finite;
16. SetGAN training at `scripts/train_setgan_stem.sh`'s recipe at 256^2 (SG3-T,
   IR-SE-50, D = DeiT-base-distilled at 224^2 + EfficientNet-lite0 at 256^2
   with seeded weights and batch norms, batch 16, references 4-7, candidates
   1-4, d_latent 128, both remats, blur sigma 2, no mean-centring): (a) one
   warm-up `train_step`, 14 forward and 7 backward launches a step (gates),
   3 timed steps (s per D step, G step and step with CUDA events, trained
   candidate images/s, peak memory, under 80 GB), one traced step (idle
   share; Dmain, Gmain, the backwards, Adam, EMA, the encoder,
   StyleAttention, the decoder, each D trunk and each D's heads); the frozen
   projector byte for byte across the steps; (b) one D and one G step at
   batch 2 in fp32 through the kernels against ``impl="ref"`` (losses within
   `MAPPER_LOSS_TOL`, every gradient within `GRAD_TOL` of its group's max),
   kernel #2 on SG3-T 256's 7 layers at batch 64 in each layer's dtype
   against its plain version (dx, and db within `DB_TOL`), timed beside the
   plain version and its bound; (d) `generate` from G_ema finite; (c) the
   pretrained recipe (ReStyle-encoder mode, 1 iteration, encoder and
   decoder frozen): one step, 28 forward and 7 backward launches, the
   encoder and decoder byte for byte, the style attention moving;
17. SetGAN's conditional FID and the registry's last families: (a)
   `train_setgan.build_trainer` at `train_setgan_stem.sh`'s recipe (phase
   16's) trained by `SetGANTrainer.train` for 2 ticks of one step with
   `make_fid_eval_fn` at the CLI's defaults (8 classes of 16 in-memory
   renders, InceptionV3 at 299^2 with its seeded init) at the second tick:
   s per evaluation, InceptionV3 ms per image at batch 16, `generate` ms
   per class, the FID in its three modes from the evaluation's features,
   peak memory, #1's launches per evaluation; (b) gates: 7 launches a
   `generate` call and 14 + 7 a training step, the evaluation's FID kept as
   the best, InceptionV3 card vs CPU on 32 images (`EVAL_TOL`), the FID of
   their features card vs CPU (`FID_CARD_TOL`), a real set against itself
   (at most `FID_SELF_TOL` of its 2 tr(cov), at least `FID_SELF_FLOOR`:
   ``sqrtm`` rounds a rank-15 product below 0), `spectrum_stats` of 16 fakes card vs
   CPU (`SPECTRUM_TOL`); (c) DenseNet-121, MobileNetV2, MNASNet-1.0,
   ShuffleNetV2-x0.5, RegNetX-032, RegNetY-032, CLIP ViT-B/32 (224^2) and
   CLIP RN50 at 256^2, batch 8, seeded with non-trivial batch norms: the
   four stages card vs CPU (`EVAL_TOL`), ms per image; (d) one fp32 D and
   G step at batch 2 with D = CLIP ViT-B/32 + RegNetY-032 through the
   kernels against ``impl="ref"`` (`MAPPER_LOSS_TOL`, `GRAD_TOL`; 14 + 7
   launches);
18. SetGAN's progressive growth and the other stems: (a) a stem snapshot
   from one `train()` step at `train_setgan_stem.sh`'s recipe (256^2), then
   `train_setgan.build_trainer` with ``--superres --path_stem`` at
   `train_setgan_superres.sh`'s recipe (512^2 grown x2 with 4 head layers,
   batch 16, references 1-2, candidates 1-2, d_latent 128, the CLI's default
   backbones, no remats) and `train()` for a warm-up and 3 timed steps (s per
   D step, G step and step, images/s, peak memory, a traced step): 11
   launches of #1 a G forward and 22 + 11 a step, the 17 carried leaves
   equal to the snapshot's and every frozen tensor byte for byte after the
   steps, a batch-2 fp32 D and G step through the kernels against
   ``impl="ref"``, and #1 and #2 on each of the grown decoder's 11 layers at
   batch 32 against the plain versions, timed beside them and their bounds;
   (b) the pretrained recipe (ReStyle-encoder mode, both frozen) from a
   reference-format ReStyle e4e ``.pt`` and an SG3-T 256 ``.pt``: the merged
   weights equal the converted files before and after 2 steps; (c) the
   ``"sg2"`` and ``"fastgan"`` stems at the stem recipe: s per step, peak
   memory, a traced step, and a batch-2 fp32 G forward card vs CPU with
   G's gradients through one cotangent of the images; (d) the
   rosinality `SG2Generator` and `SG2Discriminator` at the FFHQ 1024 widths,
   batch 4, fixed noise, card vs CPU within `EVAL_TOL`; (e)
   `convert_checkpoint --kind sg2_stem / backbone / class_embedding` on
   reference-format files, each tree equal to its source.

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
# ReStyle iterations 2-3 through the kernels vs impl="ref": each encodes the image
# of the iteration before, so the first image's error (held to IMAGE_TOL) is all
# that can reach them; every later image is held to IMAGE_TOL too, and its codes
# to 1e-3 of max |codes|. The fp32 route reproduces the plain version bit for bit
# on the H100 (phases 3-4 and this loop measured 0 on every layer and iteration).
RESTYLE_CODES_TOL = 1e-3
RESTYLE_BATCH, RESTYLE_ITERS = 2, 3  # the CLIs' defaults
EDIT_FACTORS = (-5, 6)               # inference_editing's default factor range


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


def seeded_batch_norms(model: torch.nn.Module, seed: int) -> None:
    """Non-trivial batch-norm statistics and affines, so that no BN of the
    encoder is the identity."""
    from stylegan3_editing_tpu_torch.models.backbones.common import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
            c = bn.mean.shape[0]
            bn.mean.copy_(0.1 * torch.randn(c, generator=gen))
            bn.var.copy_(0.5 + torch.randn(c, generator=gen).abs())
            if bn.scale is not None:
                bn.scale.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                bn.bias.copy_(0.1 * torch.randn(c, generator=gen))


def encoder_work(encoder: torch.nn.Module, x: torch.Tensor):
    """(bytes, flops) of one encoder call on x: x and every weight read once
    and the codes written once; 2 FLOPs a multiply-add of its convs and
    linears, counted from the shapes each one sees (forward hooks)."""
    from stylegan3_editing_tpu_torch.models.backbones.common import Conv2d
    from stylegan3_editing_tpu_torch.models.sg3.layers import FullyConnected

    flops = []

    def hook(module, inputs, out):
        fan_in = (module.kernel.shape[0] * module.kernel.shape[1] * module.kernel.shape[2]
                  if isinstance(module, Conv2d) else module.weight.shape[1])
        flops.append(2 * out.numel() * fan_in)

    handles = [m.register_forward_hook(hook) for m in encoder.modules()
               if isinstance(m, (Conv2d, FullyConnected))]
    try:
        codes = encoder(x)
    finally:
        for h in handles:
            h.remove()
    weights = sum(t.numel() * t.element_size() for t in encoder.state_dict().values())
    return x.numel() * x.element_size() + weights + codes.numel() * codes.element_size(), \
        sum(flops)


def layer_rows(dev, card, layers, layer_call, kernel_call, batch, fp32, seed, what,
               plain_chunk=None):
    """Kernel #1 on the 14 layers at ``batch``, as a path gives them to it: in
    the fp32 route (``fp32``) or each layer's own dtype. Images 0 and
    batch - 1 of the kernel's output are held against the plain version on
    the same inputs (upcast, as in phase 3), then the kernel is timed beside
    its bound (phase 5's: a bf16 radial layer's down pass at the tensor-core
    rate). With ``plain_chunk`` the plain version is timed too, on the whole
    batch in calls of ``plain_chunk`` images (its x`up` intermediate stays
    below 2^31 elements), and each layer gets a line. Returns (ms, bound ms,
    max abs err, plain ms or None)."""
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda

    total = bound = max_err = 0.0
    plain = 0.0 if plain_chunk else None
    for i, s in enumerate(layers):
        dtype = torch.bfloat16 if s.use_bf16 and not fp32 else torch.float32
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        x = torch.randn((batch, s.in_size[1], s.in_size[0], s.out_channels), generator=gen,
                        device=dev).to(dtype)
        b = torch.randn((s.out_channels,), generator=gen, device=dev).to(dtype)
        out = kernel_call(s, x, b)
        atol, rtol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        for j in (0, batch - 1):
            ref = layer_call(s, x[j:j + 1].float(), b.float(), impl="ref")
            err = (out[j:j + 1].float() - ref).abs()
            max_err = max(max_err, float(err.max()))
            if not bool((err <= atol + rtol * ref.abs()).all()):
                raise SystemExit(f"kernel disagrees with the plain version on {s.name}, "
                                 f"{what}, batch {batch}, image {j}")
            del ref, err
        k_ms = time_ms(lambda: kernel_call(s, x, b), 5)
        nbytes, up_flops, down_flops = flrelu_work(
            tuple(x.shape), tuple(out.shape), s.up_factor, len(s.up_filter),
            s.down_filter.shape[0], s.down_filter.ndim == 2, x.element_size())
        down_rate = TC_FLOPS if flrelu_cuda.mma_down(dtype, s.down_filter) else FP32_FLOPS
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, (
            up_flops / FP32_FLOPS + down_flops / down_rate) * 1e3
        total, bound = total + k_ms, bound + max(bytes_ms, ops_ms)
        if plain_chunk:
            def plain_batch():
                for n in range(0, batch, plain_chunk):
                    layer_call(s, x[n:n + plain_chunk], b, impl="ref")

            p_ms = time_ms(plain_batch, 2, warmup=1)
            plain += p_ms
            print(f"time {s.name} {str(dtype)[6:]} {what} batch {batch}, up {s.up_factor}, "
                  f"{len(s.up_filter)}-tap up, {s.down_filter.shape[0]}-tap "
                  f"{'2-D' if s.down_filter.ndim == 2 else 'separable'} down, "
                  f"{s.out_channels} channels: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"bound {max(bytes_ms, ops_ms):.4f} ms "
                  f"({'operations' if ops_ms > bytes_ms else 'bytes'}: {nbytes / 1e6:.1f} MB, "
                  f"{(up_flops + down_flops) / 1e9:.2f} GFLOP) {card}")
        del x, b, out
    torch.cuda.empty_cache()
    plain_text = f", plain {plain:.4f} ms" if plain_chunk else ""
    print(f"kernel #1, {what}: {len(layers)} layers at batch {batch}, images 0 and {batch - 1} "
          f"of each against the plain version ok (max abs err {max_err:.3e}); "
          f"{total:.4f} ms a call, alone (bound {bound:.4f} ms){plain_text} {card}")
    return total, bound, max_err, plain


def device_trace(fn, model=None, ranges=()):
    """One call of ``fn`` under `torch.profiler`, read from the trace's kernel
    events: the wall time, the device's busy time (the union of its kernels)
    and its idle share between the first kernel's start and the last one's
    end, and the launches and device time of kernels #1 and #2. Each entry
    ``(label, obj, attr)`` of ``ranges`` makes each call of ``obj.attr`` a
    range named ``label`` (``obj`` None: ``fn`` opens the range itself with
    `record_function`); with ``model`` (a `RestyleNet`) its ``encode`` and
    ``decode`` are ranges. A kernel is charged to the range its launch call
    fell in: the ranges' host time, their kernels' device time and the idle
    share of those kernels' spans. Returns None when the trace holds no
    kernel."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile, record_function

    def annotated(name, method):
        def call(*args, **kwargs):
            with record_function(name):
                return method(*args, **kwargs)
        return call

    ranges = list(ranges) + ([("encode", model, "encode"), ("decode", model, "decode")]
                             if model is not None else [])
    names = [label for label, _, _ in ranges]
    for label, obj, attr in ranges:
        if obj is not None:
            setattr(obj, attr, annotated(label, getattr(obj, attr)))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for _, obj, attr in ranges:
            if obj is not None:
                delattr(obj, attr)  # the instance attribute: the method shows again
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if not kernels:
        return None

    def busy_span(ks):
        ivs = sorted((k["ts"], k["ts"] + k["dur"]) for k in ks)
        busy, (lo, hi) = 0.0, ivs[0]
        for a, b in ivs[1:]:
            if a > hi:
                busy, lo, hi = busy + hi - lo, a, b
            else:
                hi = max(hi, b)
        return busy + hi - lo, ivs[-1][1] - ivs[0][0]

    busy, span = busy_span(kernels)
    fwd = [k for k in kernels if "flrelu_fwd_kernel" in k["name"]]
    bwd = [k for k in kernels if "flrelu_bwd_kernel" in k["name"]]
    out = {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3, "span_ms": span / 1e3,
           "idle": 1 - busy / span, "kernels": len(kernels), "flrelu_launches": len(fwd),
           "flrelu_ms": sum(k["dur"] for k in fwd) / 1e3, "flrelu_bwd_launches": len(bwd),
           "flrelu_bwd_ms": sum(k["dur"] for k in bwd) / 1e3, "ranges": names}
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    for name in names:
        ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == name]
        calls = [[k for k in kernels
                  if a <= launched.get(k.get("args", {}).get("correlation"), -1.0) <= b]
                 for a, b in ranges]
        spans = [busy_span(ks) for ks in calls if ks]
        out[name] = {"calls": len(ranges), "host_ms": sum(b - a for a, b in ranges) / 1e3,
                     "kernels": sum(map(len, calls)),
                     "device_ms": sum(k["dur"] for ks in calls for k in ks) / 1e3,
                     "idle": 1 - sum(b for b, _ in spans) / max(sum(s for _, s in spans), 1e-9)}
    return out


def print_trace(what, t, card):
    if t is None:
        print(f"trace {what}: the profiler recorded no kernel on the device; in-path device "
              f"times not measured")
        return
    bwd = (f"; kernel #2 {t['flrelu_bwd_launches']} launches, {t['flrelu_bwd_ms']:.4f} ms on "
           f"the device" if t["flrelu_bwd_launches"] else "")
    print(f"trace {what}: wall {t['wall_ms']:.4f} ms under the profiler; {t['kernels']} "
          f"kernels, device busy {t['busy_ms']:.4f} ms of the {t['span_ms']:.4f} ms from the "
          f"first kernel's start to the last one's end (idle {100 * t['idle']:.2f} %); kernel "
          f"#1 {t['flrelu_launches']} launches, {t['flrelu_ms']:.4f} ms on the device "
          f"({100 * t['flrelu_ms'] / t['busy_ms']:.2f} % of busy, "
          f"{100 * t['flrelu_ms'] / t['span_ms']:.2f} % of the span){bwd} {card}")
    for name in t["ranges"]:
        r = t[name]
        print(f"trace {what}, {name}: {r['calls']} calls, host {r['host_ms']:.4f} ms, "
              f"{r['kernels']} kernels launched inside, {r['device_ms']:.4f} ms on the "
              f"device, idle {100 * r['idle']:.2f} % of their spans {card}")


def restyle_phase(dev, card, layers, layer_call, kernel_call):
    """Phase 10: ReStyle inversion and InterFaceGAN editing at full width.
    Returns the largest error of kernel #1 against its plain version, and
    each IR-SE-50 encoder's times in ms at batch 2 (one per turn)."""
    from stylegan3_editing_tpu_torch.editing import FaceEditor
    from stylegan3_editing_tpu_torch.editing.interfacegan import RANGE_RENDER_TOL
    from stylegan3_editing_tpu_torch.models.encoders import (RestyleNet, get_average_image,
                                                             run_restyle_iterations)
    from stylegan3_editing_tpu_torch.models.sg3 import sg3_r_config
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda
    from stylegan3_editing_tpu_torch.utils.common import make_transform

    cfg = sg3_r_config(1024)
    n = RESTYLE_BATCH
    models = {}
    for i, kind in enumerate(("ProgressiveBackboneEncoder", "BackboneEncoder")):
        model = RestyleNet(cfg, kind, n_styles=cfg.num_ws, device=dev,
                           generator=torch.Generator().manual_seed(10 + i))
        seeded_batch_norms(model.encoder, 20 + i)
        with torch.no_grad():
            z = torch.randn((256, cfg.z_dim), generator=torch.Generator().manual_seed(30 + i))
            model.decoder.mapping.w_avg.copy_(model.decoder.map(z.to(dev))[:, 0].mean(0))
        models[kind] = model
    faces = (torch.rand((n, 256, 256, 3), generator=torch.Generator().manual_seed(40)) * 2
             - 1).to(dev)
    lt = torch.from_numpy(make_transform((0.05, -0.03), 5.0)).float().to(dev)

    def finite(*ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    # Drive: the average image, then 3 iterations without and with the landmarks
    # transform, for each encoder. Counts reset just before, read just after.
    with torch.inference_mode():
        flrelu_cuda.reset_launches()
        runs = {}
        for kind, model in models.items():
            avg, lat = get_average_image(model)
            runs[kind] = (avg, lat, run_restyle_iterations(model, faces, avg, lat,
                                                           n_iters=RESTYLE_ITERS),
                          run_restyle_iterations(model, faces, avg, lat, n_iters=RESTYLE_ITERS,
                                                 landmarks_transform=lt))
        torch.cuda.synchronize()
        launches = dict(flrelu_cuda.launches)
        decode_calls = len(models) * (1 + 2 * RESTYLE_ITERS)
        print(f"restyle: {len(models)} encoders x (average image + {RESTYLE_ITERS} iterations "
              f"single + {RESTYLE_ITERS} dual), batch {n}: launches {launches} for "
              f"{decode_calls} decode calls")
        if launches != {"filtered_lrelu_fwd": len(layers) * decode_calls, "filtered_lrelu_bwd": 0,
                        **NO_FIR}:
            raise SystemExit("expected 14 forward launches per decode call (a dual decode is "
                             "one call at batch 4)")
        for kind, (avg, lat, single, dual) in runs.items():
            ok = tuple(avg.shape) == (256, 256, 3) and finite(avg, lat)
            for (a, u, c), (da, du, dc) in zip(single, dual):
                ok = ok and u is None and tuple(a.shape) == tuple(da.shape) == tuple(
                    du.shape) == (n, 256, 256, 3) and tuple(c.shape) == tuple(dc.shape) == (
                    n, cfg.num_ws, 512) and finite(a, c, da, du, dc)
            dual_err = float((dual[0][0] - single[0][0]).abs().max())
            code_gap = float((single[-1][2] - single[0][2]).abs().max())
            print(f"restyle {kind}: shapes and values ok {ok}; iteration 1 aligned image, "
                  f"dual decode (batch {2 * n}) vs single decode (batch {n}): max abs err "
                  f"{dual_err:.3e} (tol {IMAGE_TOL:g}); codes moved {code_gap:.3g} from "
                  f"iteration 1 to {RESTYLE_ITERS}; max |codes| "
                  f"{float(single[-1][2].abs().max()):.3g}")
            if not (ok and dual_err <= IMAGE_TOL and code_gap > 0):
                raise SystemExit(f"ReStyle {kind}: wrong shapes, non-finite values, or the dual "
                                 "decode disagrees with the single one")

        # The same loop at the CLI's batch with the landmarks transform, so every
        # decode is the dual one at batch 4: kernels vs impl="ref".
        model = models["ProgressiveBackboneEncoder"]
        out = {}
        for impl in ("auto", "ref"):
            avg, lat = get_average_image(model, impl=impl)
            out[impl] = (avg, run_restyle_iterations(model, faces, avg, lat,
                                                     n_iters=RESTYLE_ITERS,
                                                     landmarks_transform=lt, impl=impl))
            torch.cuda.empty_cache()
        avg_err = float((out["auto"][0] - out["ref"][0]).abs().max())
        print(f"restyle e4e batch {n}, dual decode (batch {2 * n}), fp32, kernels vs "
              f"impl='ref': average image max abs err {avg_err:.3e} (tol {IMAGE_TOL:g})")
        ok = avg_err <= IMAGE_TOL
        for i, ((a, u, c), (ra, ru, rc)) in enumerate(zip(out["auto"][1], out["ref"][1])):
            c_err = float((c - rc).abs().max())
            a_err, u_err = float((a - ra).abs().max()), float((u - ru).abs().max())
            c_tol = RESTYLE_CODES_TOL * float(rc.abs().max())
            print(f"  iteration {i + 1}: codes max abs err {c_err:.3e} (tol {c_tol:.3e}: "
                  f"{RESTYLE_CODES_TOL:g} of max |ref| {float(rc.abs().max()):.3g}), aligned and "
                  f"unaligned images max abs err {a_err:.3e} and {u_err:.3e} (tol "
                  f"{IMAGE_TOL:g}, max |ref| {float(ra.abs().max()):.3g} and "
                  f"{float(ru.abs().max()):.3g})")
            ok = ok and max(a_err, u_err) <= IMAGE_TOL and c_err <= c_tol
        if not ok:
            raise SystemExit("ReStyle through the kernels disagrees with impl='ref'")
        del out
        torch.cuda.empty_cache()

        # Editing: three seeded unit directions over the CLI's factor range.
        codes = runs["ProgressiveBackboneEncoder"][2][-1][2]
        rng = np.random.RandomState(50)
        directions = {}
        for name in ("age", "smile", "pose"):
            d = rng.randn(1, 512).astype(np.float32)
            directions[name] = d / np.linalg.norm(d)
        editor = FaceEditor(model.decoder, directions=directions)
        n_factors = len(range(*EDIT_FACTORS))
        zero = -EDIT_FACTORS[0]
        plain = model.decoder.synthesize(codes)
        flrelu_cuda.reset_launches()
        edits = {name: editor.edit(codes, name, factor_range=EDIT_FACTORS)[0]
                 for name in directions}
        torch.cuda.synchronize()
        edit_launches = dict(flrelu_cuda.launches)
        print(f"edit: {len(directions)} calls of {n_factors} factors x batch {n} = "
              f"{n_factors * n} images each; launches {edit_launches}")
        if edit_launches != {"filtered_lrelu_fwd": len(layers) * len(directions),
                             "filtered_lrelu_bwd": 0, **NO_FIR}:
            raise SystemExit("expected 14 forward launches per edit call")
        scale = float(plain.abs().max())
        for name, images in edits.items():
            err = float((images[zero] - plain).abs().max()) / scale
            # What the check must tell apart: the neighbouring factors' renders
            # (an off-by-one in the range) and the pair in the other order.
            faults = {f"factor {f:+d}": float((images[zero + f] - plain).abs().max()) / scale
                      for f in (-1, 1)}
            faults["pair swapped"] = float((images[zero].flip(0) - plain).abs().max()) / scale
            ok = (len(images) == n_factors and all(
                tuple(im.shape) == (n, cfg.img_resolution, cfg.img_resolution, 3)
                for im in images) and finite(*images) and err <= RANGE_RENDER_TOL
                < min(faults.values()))
            print(f"edit {name}: factor-0 renders (batch {n_factors * n}) vs "
                  f"decoder.synthesize(codes) (batch {n}): max abs err {err:.4%} of max |ref| "
                  f"{scale:.3g} (tol {RANGE_RENDER_TOL:.2%}); the same for "
                  + ", ".join(f"{k} {v:.4%}" for k, v in faults.items())
                  + f" (each must exceed the tol) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"edit {name}: wrong shapes, non-finite values, factor-0 "
                                 "renders off the decoder's, or a fault within the tolerance")
        del edits, plain
        torch.cuda.empty_cache()

        # Timing, after the drive above as warm-up.
        x6 = torch.cat([faces, runs["ProgressiveBackboneEncoder"][0][None].expand(n, -1, -1, -1)],
                       dim=-1)
        # In turns (e4e, pSp, e4e, pSp): the host issues some hundred small launches a call.
        encoder_ms = {}
        for kind in ("ProgressiveBackboneEncoder", "BackboneEncoder") * 2:
            model = models[kind]
            nbytes, flops = encoder_work(model.encoder, x6)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
            torch.cuda.reset_peak_memory_stats()
            enc_ms = time_ms(lambda: model.encoder(x6), 10)
            encoder_ms.setdefault(kind, []).append(enc_ms)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"time encoder {kind} (IR-SE-50, 256², 6 channels, {cfg.num_ws} styles), "
                  f"batch {n}: {enc_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
                  f"({'operations' if ops_ms > bytes_ms else 'bytes'}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP at the fp32 rate), peak memory {peak:.3f} GiB {card}")
        model = models["ProgressiveBackboneEncoder"]
        avg, lat = runs["ProgressiveBackboneEncoder"][:2]
        for name, kwargs in (("single decode", {}), ("dual decode", {"landmarks_transform": lt})):
            def loop():
                run_restyle_iterations(model, faces, avg, lat, n_iters=RESTYLE_ITERS, **kwargs)

            reps = 3
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(reps):
                loop()
            torch.cuda.synchronize()
            loop_s = (time.perf_counter() - t0) / reps
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"time restyle e4e {RESTYLE_ITERS} iterations, {name}, batch {n}: "
                  f"{loop_s:.4f} s per batch, peak memory {peak:.3f} GiB {card}")
            print_trace(f"restyle e4e {RESTYLE_ITERS} iterations, {name}, batch {n}",
                        device_trace(loop, model), card)
        # Kernel #1 at the batches of the path, each image at either end of a
        # batch held against the plain version: the fp32 route at the decodes'
        # batches, each layer's own dtype at the edit call's.
        max_err = 0.0
        for batch, fp32, what in ((n, True, "fp32 route, single decode"),
                                  (2 * n, True, "fp32 route, dual decode"),
                                  (n_factors * n, False, "edit call")):
            max_err = max(max_err, layer_rows(dev, card, layers, layer_call, kernel_call, batch,
                                              fp32, 700 + 20 * batch, what)[2])
        reps = 5
        torch.cuda.reset_peak_memory_stats()
        edit_ms = time_ms(lambda: editor.edit(codes, "age", factor_range=EDIT_FACTORS), reps,
                          warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"time edit call, {n_factors} factors x batch {n} = {n_factors * n} images, bf16 "
              f"route: {edit_ms:.4f} ms per call, {n_factors * n * 1e3 / edit_ms:.4f} images/s, "
              f"peak memory {peak:.3f} GiB {card}")
        print_trace(f"edit call, {n_factors * n} images",
                    device_trace(lambda: editor.edit(codes, "age", factor_range=EDIT_FACTORS)),
                    card)
    return max_err, encoder_ms


class _Persistent:
    """Pickles as a reference `persistent_class` object does: a call of
    `torch_utils.persistence._reconstruct_persistent_obj(meta)`."""

    def __init__(self, meta):
        self.meta = meta

    def __reduce__(self):
        return sys.modules["torch_utils.persistence"]._reconstruct_persistent_obj, (self.meta,)


REFERENCE_BUFFERS = {"w_avg", "freqs", "phases", "transform", "magnitude_ema", "up_filter",
                     "down_filter"}


def _persistent(name, state, init_kwargs=None):
    """A nested `persistent_class` object for a flat state dict, one per
    module, whose embedded source raises if it is ever run."""
    params, buffers, children = {}, {}, {}
    for key, value in state.items():
        head, _, rest = key.partition(".")
        if rest:
            children.setdefault(head, {})[rest] = value
        else:
            (buffers if head in REFERENCE_BUFFERS else params)[head] = value
    return _Persistent(dict(
        type="class", version=6, class_name=name,
        module_src="raise RuntimeError('the embedded source of a pickle was run')",
        state={"_parameters": params, "_buffers": buffers,
               "_modules": {k: _persistent(k, v) for k, v in children.items()},
               "_init_kwargs": init_kwargs or {}}))


def write_reference_pickle(path, state, cfg) -> None:
    """An official-format SG3 pickle (``G``, ``G_ema``) of ``state``, with the
    config ``cfg`` captured as the generator's constructor kwargs. Stand-ins
    for the reference's `torch_utils.persistence` live in `sys.modules` only
    while it is written; its reconstruct hook raises if a reader calls it."""
    import pickle
    import types

    init_kwargs = dict(
        z_dim=cfg.z_dim, c_dim=0, w_dim=cfg.w_dim, img_resolution=cfg.img_resolution,
        img_channels=3, channel_base=cfg.channel_base, channel_max=cfg.channel_max,
        num_layers=cfg.num_layers, conv_kernel=cfg.conv_kernel,
        use_radial_filters=cfg.use_radial_filters, magnitude_ema_beta=cfg.magnitude_ema_beta)

    tu, pe = types.ModuleType("torch_utils"), types.ModuleType("torch_utils.persistence")

    def _reconstruct_persistent_obj(meta):
        raise AssertionError("a reader ran the reference's reconstruct hook")

    _reconstruct_persistent_obj.__module__ = "torch_utils.persistence"
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    pe._reconstruct_persistent_obj, tu.persistence = _reconstruct_persistent_obj, pe
    saved = {k: sys.modules.get(k) for k in ("torch_utils", "torch_utils.persistence")}
    sys.modules.update({"torch_utils": tu, "torch_utils.persistence": pe})
    try:
        g = _persistent("Generator", state, init_kwargs)
        with open(path, "wb") as f:
            pickle.dump({"G": g, "G_ema": g, "training_set_kwargs": None}, f)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def reference_state(G) -> dict:
    """A port generator's state in the reference's naming: the same names,
    conv weights HWIO → OIHW, and the stored user transform (identity).
    The GPU tests write their reference checkpoints with this and
    `write_reference_pickle` too."""
    state = {}
    for k, v in G.state_dict().items():
        v = v.detach().cpu()
        state[k] = v.permute(3, 2, 0, 1).contiguous() if k.endswith(".weight") and v.ndim == 4 \
            else v.clone()
    state["synthesis.input.transform"] = torch.eye(3)
    return state


def resnet_reference_state(n_styles: int, seed: int, input_nc: int = 6) -> dict:
    """A ReStyle ResNet-34 encoder's state dict in the reference's naming
    (``conv1``, ``bn1``, the PReLU ``relu``, layer1-4 flattened into
    ``body.N``, ``styles.J``), from seeded weights: convs normal with std
    1/sqrt(fan_in), batch norms with non-trivial statistics."""
    from stylegan3_editing_tpu_torch.models.backbones.resnet import RESNET34_LAYERS

    gen = torch.Generator().manual_seed(seed)
    state = {}

    def arr(*shape):
        z = torch.randn(shape, generator=gen)
        return z / math.sqrt(math.prod(shape[1:])) if len(shape) == 4 else z

    def bn(prefix, c):
        state[f"{prefix}.weight"] = 1 + 0.1 * arr(c)
        state[f"{prefix}.bias"] = 0.1 * arr(c)
        state[f"{prefix}.running_mean"] = 0.1 * arr(c)
        state[f"{prefix}.running_var"] = 0.5 + arr(c).abs()
        state[f"{prefix}.num_batches_tracked"] = torch.tensor(3)

    state["conv1.weight"] = arr(64, input_nc, 7, 7)
    bn("bn1", 64)
    state["relu.weight"] = 0.25 + 0.05 * arr(64)
    flat, in_c = 0, 64
    for stage_i, (blocks, c) in enumerate(RESNET34_LAYERS, start=1):
        for block_i in range(blocks):
            p = f"body.{flat}"
            state[f"{p}.conv1.weight"] = arr(c, in_c, 3, 3)
            bn(f"{p}.bn1", c)
            state[f"{p}.conv2.weight"] = arr(c, c, 3, 3)
            bn(f"{p}.bn2", c)
            if block_i == 0 and stage_i > 1:
                state[f"{p}.downsample.0.weight"] = arr(c, in_c, 1, 1)
                bn(f"{p}.downsample.1", c)
            flat, in_c = flat + 1, c
    for j in range(n_styles):
        for k in range(4):
            state[f"styles.{j}.convs.{2 * k}.weight"] = arr(512, 512, 3, 3)
            state[f"styles.{j}.convs.{2 * k}.bias"] = 0.1 * arr(512)
        state[f"styles.{j}.linear.weight"] = arr(512, 512)
        state[f"styles.{j}.linear.bias"] = 0.1 * arr(512)
    return state


def checkpoint_phase(dev, card, layers, layer_call, kernel_call, irse_ms) -> float:
    """Phase 11: a reference user's checkpoints on the card, with no JAX:
    (a) a seeded SG3-R 1024 generator written as a reference ``.pt`` and as
    an official-format pickle, converted by `convert_checkpoint`; (b)
    `run_pti_images.tune` from the pickle's ``.npz``, both modes; (c)
    ResNet-34 ReStyle pSp and e4e from a reference-format state dict through
    the converter and `load_encoder`; (d) FOV expansion of one face, and
    kernel #1 at its batch of 9 (`layer_rows`). Returns #1's largest error
    against its plain version there."""
    import shutil
    import tempfile

    from stylegan3_editing_tpu_torch.criteria import LPIPS
    from stylegan3_editing_tpu_torch.editing.interfacegan import RANGE_RENDER_TOL
    from stylegan3_editing_tpu_torch.inversion import PTI, PTIOptions
    from stylegan3_editing_tpu_torch.models.encoders import (get_average_image,
                                                             run_restyle_iterations)
    from stylegan3_editing_tpu_torch.models.sg3 import Generator, load_jax_variables, sg3_r_config
    from stylegan3_editing_tpu_torch.models.sg3.convert import npz_to_variables
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda
    from stylegan3_editing_tpu_torch.scripts import convert_checkpoint, run_pti_images
    from stylegan3_editing_tpu_torch.utils.common import make_transform
    from stylegan3_editing_tpu_torch.utils.fov_expansion import Expander
    from stylegan3_editing_tpu_torch.utils.inference_utils import load_encoder

    cfg = sg3_r_config(1024)
    res, n_layers = cfg.img_resolution, len(layers)

    def finite(*ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) The source generator: seeded weights, non-trivial EMAs, in the
        # reference's naming as a .pt state dict and as a pickle.
        src = Generator(cfg, device=dev, generator=torch.Generator().manual_seed(110))
        gen = torch.Generator().manual_seed(111)
        with torch.no_grad():
            for name, buf in src.named_buffers():
                if name.endswith("magnitude_ema"):
                    buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
            z = torch.randn((256, cfg.z_dim), generator=gen).to(dev)
            src.mapping.w_avg.copy_(src.map(z)[:, 0].mean(0))
        state = reference_state(src)
        torch.save(state, tmp / "G.pt")
        write_reference_pickle(tmp / "G.pkl", state, cfg)
        del state
        z = torch.randn((1, cfg.z_dim), generator=torch.Generator().manual_seed(112)).to(dev)
        with torch.inference_mode():
            want = src(z, force_fp32=True)
        src_state = {k: v.clone() for k, v in src.state_dict().items()}
        for name in ("G.pt", "G.pkl"):
            t0 = time.perf_counter()
            meta = convert_checkpoint.convert(str(tmp / name), str(tmp / name.replace(".", "_")))
            secs = time.perf_counter() - t0
            G = Generator(cfg, device=dev, generator=torch.Generator().manual_seed(113))
            load_jax_variables(G, npz_to_variables(tmp / f"{name.replace('.', '_')}.npz"))
            leaves = G.state_dict()
            same = sorted(leaves) == sorted(src_state) and all(
                torch.equal(leaves[k], v) for k, v in src_state.items())
            with torch.inference_mode():
                err = float((G(z, force_fp32=True) - want).abs().max())
            ok = same and err == 0 and meta["transform"] == torch.eye(3).tolist()
            print(f"checkpoint {name}: convert_checkpoint --kind auto -> {meta['kind']} in "
                  f"{secs:.3f} s; {len(leaves)} leaves equal to the source {same}; fp32 image "
                  f"batch 1 through the kernels vs the source generator's: max abs err "
                  f"{err:.3e} (tol 0) {'ok' if ok else 'FAIL'} {card}")
            if not ok:
                raise SystemExit(f"the generator converted from {name} is not the source")
            del G, leaves
        del src, src_state, want
        torch.cuda.empty_cache()

        # (b) run_pti_images' tuning from the pickle's .npz, as phase 7 sets it up.
        npz = tmp / "G_pkl.npz"
        base = npz_to_variables(npz)
        G = run_pti_images.load_generator(str(npz), cfg, dev)
        with torch.no_grad():
            ws = G.map(torch.randn((4, cfg.z_dim),
                                   generator=torch.Generator().manual_seed(1)).to(dev))
            targets = G.synthesize(ws)
        pivot = ws + 0.3 * torch.randn(ws.shape,
                                       generator=torch.Generator().manual_seed(2)).to(dev)
        lpips = LPIPS("alex", device=dev, generator=torch.Generator().manual_seed(0))
        pti = PTI(G, lpips, PTIOptions(lpips_threshold=0.0))
        steps = 5
        tuned = {}
        for mode, n_img, shared in (("per image", 2, False), ("shared", 4, True)):
            flrelu_cuda.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            images, trees, log = run_pti_images.tune(pti, pivot[:n_img], targets[:n_img],
                                                     batch_size=n_img, shared=shared,
                                                     steps=steps)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            launches = dict(flrelu_cuda.launches)
            passes = steps * (1 if shared else n_img)
            renders = 1 if shared else n_img  # the final render: one call a batch or an image
            losses = [v for entry in log for k in ("loss", "l2", "lpips") if k in entry
                      for v in np.ravel(entry[k])]
            ok = (launches == {"filtered_lrelu_fwd": n_layers * (passes + renders),
                               "filtered_lrelu_bwd": n_layers * passes, **NO_FIR}
                  and all(math.isfinite(v) for v in losses) and losses and finite(images)
                  and tuple(images.shape) == (n_img, res, res, 3)
                  and len(trees) == (1 if shared else n_img))
            per = (f"{secs / steps:.4f} s per step" if shared
                   else f"{secs / (steps * n_img):.4f} s per image-step")
            print(f"run_pti_images.tune {mode}, {n_img} images x {steps} steps: launches "
                  f"{launches}; {len(losses)} losses finite; {per} (final render included), "
                  f"peak memory {peak:.3f} GiB {card}")
            if not ok:
                raise SystemExit(f"run_pti_images.tune {mode}: launch counts, non-finite "
                                 "losses or images, or wrong shapes")
            tuned[mode] = (images, trees)
        # A per-image tree through the CLI's writer loads back into a generator
        # whose render is the CLI's final render.
        images, trees = tuned["per image"]
        run_pti_images.save_tuned(trees[1], tmp / "b_model.npz")
        G2 = Generator(cfg, device=dev, generator=torch.Generator().manual_seed(114))
        load_jax_variables(G2, run_pti_images.tuned_variables(
            base, npz_to_variables(tmp / "b_model.npz")["synthesis_tuned"]))
        with torch.no_grad():
            again = G2.synthesize(pivot[1:2], force_fp32=pti.force_fp32)
        err = float((again[0] - images[1]).abs().max())
        print(f"run_pti_images: image 1's tree from b_model.npz renders its final image: max abs "
              f"err {err:.3e} (tol {IMAGE_TOL:g})")
        if not err <= IMAGE_TOL:
            raise SystemExit("a tuned tree written by the CLI does not render its final image")
        del pti, lpips, G2, again, tuned, images, trees, ws, targets, pivot
        torch.cuda.empty_cache()

        # (c) ResNet-34 ReStyle, pSp and e4e, from a reference state dict.
        # Saved as the reference saves a ReStyle model: the encoder's keys
        # under ``encoder.`` and the encoder type in ``opts``.
        encoder_state = {f"encoder.{k}": v
                         for k, v in resnet_reference_state(cfg.num_ws, seed=120).items()}
        models = {}
        for kind in ("ResNetProgressiveBackboneEncoder", "ResNetBackboneEncoder"):
            src = tmp / f"restyle_{kind}.pt"
            torch.save({"state_dict": encoder_state, "opts": {"encoder_type": kind}}, src)
            t0 = time.perf_counter()
            meta = convert_checkpoint.convert(str(src), str(tmp / kind), kind="encoder")
            model, opts = load_encoder(meta["checkpoint"], generator_variables=base, device=dev)
            print(f"checkpoint {src.name}: converted and loaded in "
                  f"{time.perf_counter() - t0:.3f} s ({meta['encoder']}, {opts.input_nc} input "
                  f"channels, decoder {opts.output_size}²)")
            if meta["encoder"] != {"trunk": "resnet34", "n_styles": cfg.num_ws} or \
                    model.encoder_type != kind:
                raise SystemExit(f"the ResNet checkpoint did not convert as {kind}")
            shutil.rmtree(meta["checkpoint"])
            (tmp / f"{kind}.npz").unlink()
            src.unlink()
            models[kind] = model
        n = RESTYLE_BATCH
        faces = (torch.rand((n, 256, 256, 3), generator=torch.Generator().manual_seed(40)) * 2
                 - 1).to(dev)
        lt = torch.from_numpy(make_transform((0.05, -0.03), 5.0)).float().to(dev)
        with torch.inference_mode():
            for kind, model in models.items():
                out, launches = {}, {}
                for impl in ("auto", "ref"):
                    flrelu_cuda.reset_launches()
                    avg, lat = get_average_image(model, impl=impl)
                    out[impl] = (avg, run_restyle_iterations(
                        model, faces, avg, lat, n_iters=RESTYLE_ITERS, landmarks_transform=lt,
                        impl=impl))
                    torch.cuda.synchronize()
                    launches[impl] = dict(flrelu_cuda.launches)
                    torch.cuda.empty_cache()
                ok = launches["auto"] == {"filtered_lrelu_fwd": n_layers * (1 + RESTYLE_ITERS),
                                          "filtered_lrelu_bwd": 0, **NO_FIR}
                avg_err = float((out["auto"][0] - out["ref"][0]).abs().max())
                ok = ok and avg_err <= IMAGE_TOL and launches["ref"]["filtered_lrelu_fwd"] == 0
                print(f"restyle {kind} batch {n}, dual decode (batch {2 * n}), fp32: launches "
                      f"{launches['auto']} for {1 + RESTYLE_ITERS} decode calls; kernels vs "
                      f"impl='ref': average image max abs err {avg_err:.3e} (tol {IMAGE_TOL:g})")
                for i, ((a, u, c), (ra, ru, rc)) in enumerate(zip(out["auto"][1],
                                                                  out["ref"][1])):
                    c_err = float((c - rc).abs().max())
                    a_err, u_err = float((a - ra).abs().max()), float((u - ru).abs().max())
                    c_tol = RESTYLE_CODES_TOL * float(rc.abs().max())
                    print(f"  iteration {i + 1}: codes max abs err {c_err:.3e} (tol "
                          f"{c_tol:.3e}), aligned and unaligned images {a_err:.3e} and "
                          f"{u_err:.3e} (tol {IMAGE_TOL:g})")
                    ok = ok and finite(a, u, c) and max(a_err, u_err) <= IMAGE_TOL and \
                        c_err <= c_tol and tuple(u.shape) == (n, 256, 256, 3)
                if not ok:
                    raise SystemExit(f"ReStyle {kind}: launch counts, or the kernels disagree "
                                     "with impl='ref'")
                del out
            # Timing, after the drive above as warm-up; the encoders in turns.
            avg = get_average_image(models["ResNetProgressiveBackboneEncoder"])[0]
            x6 = torch.cat([faces, avg[None].expand(n, -1, -1, -1)], dim=-1)
            for kind in tuple(models) * 2:
                model = models[kind]
                nbytes, flops = encoder_work(model.encoder, x6)
                bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
                torch.cuda.reset_peak_memory_stats()
                enc_ms = time_ms(lambda: model.encoder(x6), 10)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                irse = irse_ms[kind.replace("ResNet", "")]
                print(f"time encoder {kind} (ResNet-34, 256², 6 channels, {cfg.num_ws} styles), "
                      f"batch {n}: {enc_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
                      f"({'operations' if ops_ms > bytes_ms else 'bytes'}: {nbytes / 1e6:.1f} "
                      f"MB, {flops / 1e9:.2f} GFLOP at the fp32 rate); IR-SE-50 in phase 10: "
                      f"{' / '.join(f'{v:.4f}' for v in irse)} ms; peak memory {peak:.3f} GiB "
                      f"{card}")
            for kind, model in models.items():
                avg, lat = get_average_image(model)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                reps = 3
                for _ in range(reps):
                    run_restyle_iterations(model, faces, avg, lat, n_iters=RESTYLE_ITERS,
                                           landmarks_transform=lt)
                torch.cuda.synchronize()
                loop_s = (time.perf_counter() - t0) / reps
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                print(f"time restyle {kind} {RESTYLE_ITERS} iterations, dual decode, batch {n}: "
                      f"{loop_s:.4f} s per batch, peak memory {peak:.3f} GiB {card}")
        del models, model, faces, x6
        torch.cuda.empty_cache()

        # (d) FOV expansion of one face: 9 views in one synthesize (bf16 route).
        # The canvas' centre is held against a batch-1 render within the
        # generator tests' bf16 image tolerance, of max |ref|: ws is tiled, so
        # the batch style RMS is the same in both, and what can differ is the
        # library matmul of the modulated convs at another batch size (a tile
        # or split choice that moves a sum's rounding); one bf16 ulp moved on
        # any of L5-L13 can grow through the layers above it. A view that is
        # not the centre's (the unshifted left view read at the centre) is
        # another image, far beyond it.
        fov_tol = RANGE_RENDER_TOL
        ws = G.map(torch.randn((1, cfg.z_dim), generator=torch.Generator().manual_seed(130))
                   .to(dev), truncation_psi=0.7).detach()
        lt_np = make_transform((0.02, -0.04), 4.0)
        pad = res // 4  # 256 pixels on each side at 1024²
        exp = Expander(G, res)
        with torch.inference_mode():
            flrelu_cuda.reset_launches()
            canvas = exp.generate_expanded_image(ws, lt_np, pad, pad, pad, pad)
            torch.cuda.synchronize()
            launches = dict(flrelu_cuda.launches)
            plain = G.synthesize(ws, transform=torch.from_numpy(lt_np).float().to(dev))
            scale = float(plain.abs().max())
            centre = canvas[:, pad:pad + res, pad:pad + res]
            err = float((centre - plain).abs().max()) / scale
            fault = float((exp.views(ws, lt_np, pad, pad, pad, pad)["left"] - plain)
                          .abs().max()) / scale
            ok = (tuple(canvas.shape) == (1, res + 2 * pad, res + 2 * pad, 3) and finite(canvas)
                  and launches == {"filtered_lrelu_fwd": n_layers, "filtered_lrelu_bwd": 0,
                                   **NO_FIR}
                  and err <= fov_tol < fault)
            print(f"fov: canvas {tuple(canvas.shape)} from 9 views in one synthesize (batch 9), "
                  f"launches {launches}; centre vs synthesize(ws, landmark_t) at batch 1: max abs "
                  f"err {err:.4%} of max |ref| {scale:.3g} (tol {fov_tol:.2%}); the unshifted "
                  f"left view there {fault:.4%} (must exceed the tol) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("FOV expansion: wrong canvas, launch counts, or a centre off "
                                 "the plain render (or the fault within the tolerance)")
            del canvas, plain, centre
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fov_ms = time_ms(lambda: exp.generate_expanded_image(ws, lt_np, pad, pad, pad, pad),
                             3, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"time fov expansion, 9 views x {res}² -> {res + 2 * pad}², bf16 route: "
              f"{fov_ms:.4f} ms per expanded image, peak memory {peak:.3f} GiB {card}")
    del exp, G
    torch.cuda.empty_cache()
    return layer_rows(dev, card, layers, layer_call, kernel_call, 9, False, 900,
                      "fov expansion")[2]


# Phase 12's tolerances, fixed before its first run.
# S statistics against a float64 two-pass recomputation from the same samples:
# the mean is a float32 cast of a float64 mean (2^-24 of it; 2^-23 of |mean| +
# std covers a last-bit difference of a sample); the std is
# sqrt(E[x^2] - float32(mean)^2 + 1e-12), whose float32 square of the mean moves
# the variance by up to 2^-23 mean^2 (the std by 2^-24 mean^2 / std), the 1e-12
# by up to 1e-6, and the float32 cast by 2^-24 std: 2^-22 (std + mean^2 / std)
# + 1e-6 holds twice those.
STATS_STD_TOL = (2 ** -22, 1e-6)
# delta_i_c rows through the kernels vs impl="ref" at the same batch: unit
# vectors, each the normalised difference of the CLIP features of two bf16
# renders, which the two routes round apart by up to RANGE_RENDER_TOL of the
# image; where a channel moves its renders little that turns the row by many
# degrees (the CPU test of the CLIs reads cosines down to 0.95 between the two
# packages' bf16 renders), so a row must keep a cosine of at least 0.9 (26 deg);
# the +/- renders swapped give the row's negative (cosine -1).
DELTA_COS_TOL = 0.9
CLIP_TOL = 1e-4  # CLIP's image features, card vs CPU, of max |ref|: fp32 sum order
STATS_SAMPLES, STATS_BATCH = 100_000, 1024  # styleclip_preprocess' defaults
DELTA_GROUPS = ("input", "L0_36_1024", "L7_276_645", "L13_1024_64", "L14_1024_3")
VIDEO_FRAMES, VIDEO_BATCH = 12, 4  # inference_on_video's batch size


def bpe_vocabulary(path) -> None:
    """A small BPE merges file in the released vocabulary's format."""
    import gzip

    merges = ["f a", "fa c", "fac e</w>", "s m", "sm i", "smi l", "smil i", "smili n",
              "smilin g</w>", "p h", "ph o", "pho t", "phot o</w>", "o f</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")


def styleclip_video_phase(dev, card, layers, layer_call, kernel_call) -> float:
    """Phase 12: StyleCLIP global directions and the video pipeline at full
    width, seeded weights: (a) `compute_s_statistics` at the CLI's defaults
    against a float64 recomputation on the card; (b) `delta_i_c_batch` on the
    first 8 channels of five groups (16 renders and a CLIP encode each),
    one batch through the kernels against ``impl="ref"``, and CLIP's image
    features on the card against the CPU; (c) a StyleCLIP edit at batch 2;
    (d) the video path on tensors: ReStyle with landmarks transforms, the
    smoothed FOV renders, both video editors; then kernel #1 at every new
    batch of the path (`layer_rows`). Returns #1's largest error there."""
    import copy
    import tempfile

    from stylegan3_editing_tpu_torch.editing.interfacegan import RANGE_RENDER_TOL
    from stylegan3_editing_tpu_torch.editing.styleclip_global import (
        DEFAULT_TEMPLATES, StyleCLIPGlobalDirection, apply_delta_s, compute_s_statistics,
        delta_i_c_batch, s_key_order)
    from stylegan3_editing_tpu_torch.models.backbones.clip import (CLIP, SimpleTokenizer,
                                                                   clip_preprocess_from_synth)
    from stylegan3_editing_tpu_torch.models.encoders import (RestyleNet, get_average_image,
                                                             run_restyle_iterations)
    from stylegan3_editing_tpu_torch.models.sg3 import Generator, sg3_r_config
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda
    from stylegan3_editing_tpu_torch.utils.common import generate_random_transform
    from stylegan3_editing_tpu_torch.video.post_processing import (
        postprocess_and_smooth_inversions, smooth_ws)
    from stylegan3_editing_tpu_torch.video.video_editor import (InterFaceGANVideoEditor,
                                                                StyleCLIPVideoEditor)

    cfg = sg3_r_config(1024)
    res, n_layers = cfg.img_resolution, len(layers)

    def finite(*ts):
        return all(bool(torch.isfinite(torch.as_tensor(t)).all()) for t in ts)

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # Seeded weights; the leaves that start at zero (the input transform's
    # affine among them, which would hold its StyleSpace channels constant)
    # drawn from a seed too, as the parity tests do.
    G = Generator(cfg, device=dev, generator=torch.Generator().manual_seed(150))
    gen = torch.Generator().manual_seed(151)
    with torch.no_grad():
        for p in G.parameters():
            if not p.any():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        z = torch.randn((256, cfg.z_dim), generator=gen).to(dev)
        G.mapping.w_avg.copy_(G.map(z)[:, 0].mean(0))

    # (a) S statistics at the CLI's defaults, then the float64 recomputation
    # from the same samples (all 100,000 kept on the card, two passes).
    n_stats, batch = STATS_SAMPLES, STATS_BATCH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    transform, s_mean, s_std, s_1k = compute_s_statistics(G, num_images=n_stats, batch=batch)
    stats_s = sync_s(t0)
    keys = list(s_mean)
    channels = sum(v.shape[0] for v in s_mean.values())
    rnd = np.random.RandomState(0)
    samples = {k: [] for k in keys}
    with torch.no_grad():
        for start in range(0, n_stats, batch):
            z = torch.as_tensor(rnd.randn(min(batch, n_stats - start), cfg.z_dim)
                                .astype(np.float32), device=dev)
            s = G.w2s(G.map(z, truncation_psi=0.5, truncation_cutoff=8))
            for k in keys:
                samples[k].append(s[k])
    mean_err = std_err = 0.0
    ok = keys == s_key_order(keys) and len(keys) == cfg.num_ws and keys[-1] == "input"
    for k in keys:
        x = torch.cat(samples.pop(k)).double()
        m = x.mean(0)
        sd = (x - m).square().mean(0).sqrt()
        del x
        got_m = torch.as_tensor(s_mean[k], device=dev).double()
        got_sd = torch.as_tensor(s_std[k], device=dev).double()
        m_tol = 2 ** -23 * (m.abs() + sd)
        sd_tol = STATS_STD_TOL[0] * (sd + m.square() / sd) + STATS_STD_TOL[1]
        mean_err = max(mean_err, float(((got_m - m).abs() / m_tol).max()))
        std_err = max(std_err, float(((got_sd - sd).abs() / sd_tol).max()))
    ok = ok and mean_err <= 1 and std_err <= 1 and s_1k["input"].shape == (1000, 4) and \
        all(math.isfinite(v) for v in transform.values())
    print(f"styleclip s statistics: {n_stats} z at batch {batch}, psi 0.5, cutoff 8: "
          f"{stats_s:.3f} s ({len(keys)} groups, {channels} channels, float64 sums on the "
          f"card); against a float64 two-pass recomputation from the same samples: worst "
          f"mean error {mean_err:.3g} and worst std error {std_err:.3g} of their tolerances "
          f"(mean 2^-23 (|mean| + std); std {STATS_STD_TOL[0]:.3g} (std + mean^2 / std) + "
          f"{STATS_STD_TOL[1]:g}); transform {transform} {'ok' if ok else 'FAIL'} {card}")
    if not ok:
        raise SystemExit("S statistics disagree with the float64 recomputation")
    del samples
    torch.cuda.empty_cache()

    # (b) delta_i_c batches: the first batch of 8 channels of five groups (the
    # input transform has 4), each 2 renders a channel at 1024^2 (bf16 route)
    # and a CLIP ViT-B/32 encode.
    clip_model = CLIP(device=dev, generator=torch.Generator().manual_seed(152))
    embed = clip_model.text_projection.shape[1]
    base = {k: torch.as_tensor(v[:1], device=dev) for k, v in s_1k.items()}
    first = {k: list(range(min(8, s_mean[k].shape[0]))) for k in DELTA_GROUPS}
    with torch.inference_mode():
        delta_i_c_batch(G, clip_model, base, s_mean, s_std, DELTA_GROUPS[1],
                        first[DELTA_GROUPS[1]])  # warm-up
        flrelu_cuda.reset_launches()
        batch_ms = {}
        for layer in DELTA_GROUPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = delta_i_c_batch(G, clip_model, base, s_mean, s_std, layer, first[layer])
            batch_ms[layer] = sync_s(t0) * 1e3
            if not (tuple(d.shape) == (len(first[layer]), embed) and finite(d)
                    and float((d.norm(dim=-1) - 1).abs().max()) < 1e-4):
                raise SystemExit(f"delta_i_c {layer}: wrong shape or rows not unit vectors")
        launches = dict(flrelu_cuda.launches)
        per_channel = sum(batch_ms.values()) / sum(map(len, first.values()))
        print(f"delta_i_c: the first batch of five groups ({', '.join(f'{k} {len(v)}' for k, v in first.items())} "
              f"channels, 2 renders a channel at {res}^2 and a CLIP encode): "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in batch_ms.items())
              + f"; {per_channel:.3f} ms per channel; the full S of {channels} channels: "
              f"{channels * per_channel / 1e3:.1f} s per sample; launches {launches} {card}")
        if launches != {"filtered_lrelu_fwd": n_layers * len(DELTA_GROUPS),
                        "filtered_lrelu_bwd": 0, **NO_FIR}:
            raise SystemExit("expected 14 forward launches per delta_i_c batch")
        # One batch (4 channels of L7, 8 renders: the plain version at 16 would
        # take ~11 s) through the kernels against impl="ref" at the same batch.
        four = [0, 1, 2, 3]
        got = delta_i_c_batch(G, clip_model, base, s_mean, s_std, DELTA_GROUPS[2], four)
        ref = delta_i_c_batch(G, clip_model, base, s_mean, s_std, DELTA_GROUPS[2], four,
                              impl="ref")
        cos = (got * ref).sum(-1)
        swapped = (-got * ref).sum(-1)  # the +/- renders swapped negate a row
        neighbour = (got[1:] * ref[:-1]).sum(-1)
        ok = float(cos.min()) >= DELTA_COS_TOL > float(swapped.max())
        print(f"delta_i_c {DELTA_GROUPS[2]} channels 0-3 (batch 8), kernels vs impl='ref': "
              f"cosines "
              f"{[round(float(c), 5) for c in cos]} (tol >= {DELTA_COS_TOL}); the +/- renders "
              f"swapped {float(swapped.max()):.4f}; the neighbouring channel's row "
              f"{[round(float(c), 4) for c in neighbour]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("delta_i_c through the kernels disagrees with impl='ref'")
        # CLIP's image features on the card against the same module on the CPU.
        z = torch.randn((16, cfg.z_dim), generator=torch.Generator().manual_seed(153)).to(dev)
        x = clip_preprocess_from_synth(G(z, truncation_psi=0.7), clip_model.image_resolution)
        on_card = clip_model.encode_image(x)
        on_cpu = copy.deepcopy(clip_model).cpu().encode_image(x.cpu())
        err = float((on_card.cpu() - on_cpu).abs().max())
        scale = float(on_cpu.abs().max())
        print(f"clip ViT-B/32 image features, batch 16 at 224^2, card vs CPU: max abs err "
              f"{err:.3e} (tol {CLIP_TOL:g} of max |ref| {scale:.3g}) "
              f"{'ok' if err <= CLIP_TOL * scale else 'FAIL'}")
        if not err <= CLIP_TOL * scale:
            raise SystemExit("CLIP's features on the card disagree with the CPU's")
        del got, ref, x, on_card, on_cpu

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        bpe_vocabulary(tmp / "vocab.txt.gz")
        tok = SimpleTokenizer(str(tmp / "vocab.txt.gz"))
        rng = np.random.RandomState(154)
        # A seeded delta_i_c (the full one takes minutes per sample, (b)).
        d_ic = rng.randn(channels, embed).astype(np.float32)
        d_ic /= np.linalg.norm(d_ic, axis=-1, keepdims=True)
        gd = StyleCLIPGlobalDirection(d_ic, s_std, DEFAULT_TEMPLATES,
                                      {k: v[None] for k, v in s_mean.items()}, clip_model, tok)

        # (c) A StyleCLIP edit at batch 2: the CLI's alpha 2.0 and beta 0.11.
        with torch.inference_mode():
            ws = G.map(torch.randn((2, cfg.z_dim), generator=torch.Generator().manual_seed(155))
                       .to(dev), truncation_psi=0.7)
            all_s = G.w2s(ws)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            delta_s = gd.get_delta_s("face", "smiling face", 0.11)
            delta_ms = sync_s(t0) * 1e3
            flrelu_cuda.reset_launches()
            edited = apply_delta_s(all_s, delta_s, 2.0)
            img = G.synthesize(None, all_s=edited)
            torch.cuda.synchronize()
            launches = dict(flrelu_cuda.launches)
            # The gate: the fp32 route through the kernels against impl="ref"
            # (bit for bit in phases 4 and 10), which the unedited render must
            # miss. The bf16 route's renders are printed against the fp32 one:
            # the kernel rounds once a layer, the plain bf16 composition at
            # every op, so they land apart by about what the bf16 policy
            # costs each (the generator tests' 2 sqrt(8 L) 2^-9 model).
            got32 = G.synthesize(None, all_s=edited, force_fp32=True)
            ref32 = G.synthesize(None, all_s=edited, force_fp32=True, impl="ref")
            plain32 = G.synthesize(None, all_s=all_s, force_fp32=True, impl="ref")
            err = float((got32 - ref32).abs().max())
            fault = float((plain32 - ref32).abs().max())
            ref16 = G.synthesize(None, all_s=edited, impl="ref")
            scale = float(ref32.abs().max())
            bf16 = {name: float((x - ref32).abs().max()) / scale
                    for name, x in (("kernels", img), ("plain", ref16))}
            bf16["kernels vs plain"] = float((img - ref16).abs().max()) / scale
            zeroed = sum(int((v == 0).sum()) for v in delta_s.values())
            ok = (tuple(img.shape) == (2, res, res, 3) and finite(img) and launches ==
                  {"filtered_lrelu_fwd": n_layers, "filtered_lrelu_bwd": 0, **NO_FIR}
                  and err <= IMAGE_TOL < fault and tuple(delta_s) == tuple(s_mean))
            print(f"styleclip edit, batch 2, alpha 2.0, beta 0.11 ({zeroed} of {channels} "
                  f"channels below beta): launches {launches}; fp32 route, kernels vs "
                  f"impl='ref': max abs err {err:.3e} (tol {IMAGE_TOL:g}); the unedited render "
                  f"there {fault:.3e} (must exceed the tol); bf16 route (the edit's own) off the "
                  f"fp32 render, of max |ref|: " + ", ".join(f"{k} {v:.4%}" for k, v in
                                                           bf16.items())
                  + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("StyleCLIP edit: launches, shapes, or the kernels disagree "
                                 "with impl='ref'")
            del got32, ref32, plain32, ref16
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            synth_ms = time_ms(lambda: G.synthesize(None, all_s=apply_delta_s(all_s, delta_s,
                                                                            2.0)), 5)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"time styleclip edit: get_delta_s {delta_ms:.2f} ms (2 prompts x "
              f"{len(DEFAULT_TEMPLATES)} templates through CLIP's text encoder, first call), "
              f"apply_delta_s + synthesize(all_s) at batch 2 {synth_ms:.3f} ms, "
              f"{2e3 / synth_ms:.3f} images/s, peak memory {peak:.3f} GiB {card}")

        # (d) The video path on tensors: 12 frames of 256^2, per-frame transforms.
        # e4e on IR-SE-50 as phase 10, decoding with (a)'s generator.
        model = RestyleNet(cfg, "ProgressiveBackboneEncoder", n_styles=cfg.num_ws, device=dev,
                           generator=torch.Generator().manual_seed(156))
        seeded_batch_norms(model.encoder, 157)
        model.decoder.load_state_dict(G.state_dict())
        base_img = torch.rand((1, 256, 256, 3), generator=torch.Generator().manual_seed(158))
        frames = (torch.cat([base_img.roll(2 * i, dims=2) for i in range(VIDEO_FRAMES)]) * 2
                  - 1).to(dev)
        rng = np.random.RandomState(159)
        transforms = [generate_random_transform(0.02, 3.0, rng).astype(np.float32)
                      for _ in range(VIDEO_FRAMES)]
        lts = torch.as_tensor(np.stack(transforms), device=dev)
        direction = rng.randn(1, 512).astype(np.float32)
        direction /= np.linalg.norm(direction)
        pad = res // 4
        expansion = (pad, pad, pad, pad)
        smoothed_n = VIDEO_FRAMES - 4
        times = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flrelu_cuda.reset_launches()
        with torch.inference_mode():
            t0 = time.perf_counter()
            avg, lat = get_average_image(model)
            codes = torch.cat([run_restyle_iterations(
                model, frames[b:b + VIDEO_BATCH], avg, lat, n_iters=RESTYLE_ITERS,
                landmarks_transform=lts[b:b + VIDEO_BATCH], force_fp32=True)[-1][2]
                for b in range(0, VIDEO_FRAMES, VIDEO_BATCH)])
            times["restyle"] = sync_s(t0)
            latents = codes.cpu().numpy()
            t0 = time.perf_counter()
            smoothed = postprocess_and_smooth_inversions(
                {f"{i:04d}.png": c for i, c in enumerate(latents)}, transforms, model.decoder,
                res, expansion)
            times["smooth"] = sync_s(t0)
            editor = InterFaceGANVideoEditor(model.decoder, res, tmp, {"age": direction},
                                             expansion)
            t0 = time.perf_counter()
            img_s, img_e, lat_s, lat_e = editor.edit("age", -2, 2, latents, transforms)
            times["edit"] = sync_s(t0)
            smoothed_t = smooth_ws(np.stack(transforms))
            t0 = time.perf_counter()
            edit_frames = [editor.postprocess_and_smooth_edits(lat, smoothed_t)
                           for lat in (lat_s, lat_e)]
            times["edit smooth"] = sync_s(t0)
            sc_editor = StyleCLIPVideoEditor(model.decoder, res, tmp, gd, expansion)
            t0 = time.perf_counter()
            sc_images, _ = sc_editor.edit("smiling face", 2.0, 0.11, latents,
                                          landmarks_transforms=transforms)
            times["styleclip"] = sync_s(t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = dict(flrelu_cuda.launches)
        decode_calls = 1 + (VIDEO_FRAMES // VIDEO_BATCH) * RESTYLE_ITERS
        renders = smoothed_n + 2 + 2 * smoothed_n + 1
        canvas = (res + 2 * pad, res + 2 * pad, 3)
        ok = (launches == {"filtered_lrelu_fwd": n_layers * (decode_calls + renders),
                           "filtered_lrelu_bwd": 0, **NO_FIR}
              and latents.shape == (VIDEO_FRAMES, cfg.num_ws, 512) and finite(latents)
              and len(smoothed) == smoothed_n
              and all(f.shape == canvas and f.dtype == np.uint8 for f in smoothed)
              and all(len(fs) == smoothed_n and all(f.shape == canvas for f in fs)
                      for fs in edit_frames)
              and tuple(img_s.shape) == tuple(sc_images.shape) == (VIDEO_FRAMES, res, res, 3)
              and finite(img_s, img_e, sc_images)
              and np.abs(lat_s - (latents - 2 * direction)).max() <= 1e-5
              and np.abs(lat_e - (latents + 2 * direction)).max() <= 1e-5)
        print(f"video: {VIDEO_FRAMES} frames of 256^2, ReStyle e4e at batch {VIDEO_BATCH} x "
              f"{RESTYLE_ITERS} iterations with landmarks transforms (fp32 dual decode), "
              f"{smoothed_n} smoothed {canvas[0]}^2 frames, InterFaceGAN -2/+2 and StyleCLIP "
              f"edits of every frame: launches {launches} ({decode_calls} decode calls, "
              f"{renders} renders) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("video path: launch counts, shapes, non-finite values or edit "
                             "latents off their direction")
        print(f"time video (first calls): ReStyle {1e3 * times['restyle'] / VIDEO_FRAMES:.2f} "
              f"ms per input frame; smoothed FOV render {1e3 * times['smooth'] / smoothed_n:.2f} "
              f"ms per output frame; InterFaceGAN edit (2 x batch {VIDEO_FRAMES}) "
              f"{1e3 * times['edit'] / (2 * VIDEO_FRAMES):.2f} ms per edited frame, its smoothed "
              f"renders {1e3 * times['edit smooth'] / (2 * smoothed_n):.2f} ms per output "
              f"frame; StyleCLIP edit (batch {VIDEO_FRAMES}) "
              f"{1e3 * times['styleclip'] / VIDEO_FRAMES:.2f} ms per frame; peak memory "
              f"{peak:.3f} GiB {card}")
    del model, G, clip_model, gd, smoothed, edit_frames, img_s, img_e, sc_images
    torch.cuda.empty_cache()
    # Kernel #1 at the batches this path gives it: delta_i_c's 16 renders, the
    # video edits' 12 frames, the FOV render's 9 views (bf16 route); the video
    # ReStyle's dual decode at batch 8 (fp32 route); the StyleCLIP edit's 2.
    max_err = 0.0
    for batch, fp32, what in ((16, False, "delta_i_c batch"), (12, False, "video edit"),
                              (9, False, "video fov render"), (8, True, "video ReStyle dual "
                                                                      "decode, fp32 route"),
                              (2, False, "styleclip edit")):
        max_err = max(max_err, layer_rows(dev, card, layers, layer_call, kernel_call, batch,
                                          fp32, 1200 + 20 * batch, what)[2])
    return max_err


SCORER_TOL = 1e-4  # a scorer's outputs, card vs CPU, of max |ref|: fp32 sum order (cuDNN, fp32)
BOUNDARY_SAMPLES, BOUNDARY_BATCHES, BOUNDARY_BATCH = 256, 4, 8  # one chunk of z; the CLI's batch
BOUNDARY_ESTIMATE = 10_000  # the CLI's default n_samples
SCORERS = ("age", "pose_yaw", "Smiling")  # VGG16, ResNet-50 + bin heads, ResNet-50 + 40 logits
MAPPER_STEPS, MAPPER_BATCH = 12, 2  # past RAdam's switch at step 6 and two lookahead syncs
# The mapper's losses through the kernels vs impl="ref": relative, plus 4 ulp of 1
# (the CLIP and ID losses are 1 - a cosine near 1, which cancels to its rounding).
MAPPER_LOSS_TOL = (1e-4, 2.0 ** -20)
MTCNN_BATCH, ID_BATCH = 64, 4


def editing_training_phase(dev, card, layers, bwd_kernel_call, bwd_plain_call):
    """Phase 13: the editing side's training at full width, seeded weights:
    (a) `train_boundaries` up to the scores (256 z at psi 0.7, pseudo-aligned;
    each scorer on 4 batches of 8 bf16 renders, one batch card vs CPU); (b)
    `MapperCoach` at SG3-R 1024 (LevelsMapper, CLIP ViT-B/32, IR-SE-50,
    Ranger, batch 2, 12 steps; one step through the kernels against
    ``impl="ref"``; a traced step); (c) kernel #2's fp32 route at batch 2 on
    the 14 layers, against `filtered_lrelu_bwd_ref` and timed beside its
    bounds; (d) MTCNN's nets on a 1024^2 image's scale pyramid and at batch
    64, and `calc_id_loss_parallel`'s IR-101 at batch 4, card vs CPU.
    Returns #2's largest error."""
    import copy
    import tempfile

    import torch.nn.functional as F
    from torch.profiler import record_function

    from stylegan3_editing_tpu_torch.editing.styleclip_mapper import (MapperCoach,
                                                                     MapperTrainOptions)
    from stylegan3_editing_tpu_torch.models.backbones.clip import CLIP, SimpleTokenizer
    from stylegan3_editing_tpu_torch.models.backbones.irse import IRSEBackbone
    from stylegan3_editing_tpu_torch.models.mtcnn import MTCNN
    from stylegan3_editing_tpu_torch.models.sg3 import Generator, sg3_r_config
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda
    from stylegan3_editing_tpu_torch.scripts import calc_id_loss_parallel, train_boundaries

    cfg = sg3_r_config(1024)
    n_layers = len(layers)

    def finite(*ts):
        return all(bool(torch.isfinite(torch.as_tensor(t)).all()) for t in ts)

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def close(got, ref, tol):
        err = float((got.float().cpu() - ref.float().cpu()).abs().max())
        return err, float(ref.abs().max()), err <= tol * float(ref.abs().max())

    G = Generator(cfg, device=dev, generator=torch.Generator().manual_seed(160))
    with torch.no_grad():
        z = torch.randn((256, cfg.z_dim), generator=torch.Generator().manual_seed(161)).to(dev)
        G.mapping.w_avg.copy_(G.map(z)[:, 0].mean(0))

    # (a) train_boundaries up to the scores: one chunk of 256 z, pseudo-aligned.
    opts = train_boundaries.BoundaryOptions(n_samples=BOUNDARY_SAMPLES, batch_size=BOUNDARY_BATCH,
                                            truncation_psi=0.7, pseudo_align=True, seed=162,
                                            device="cuda")
    t0 = time.perf_counter()
    ws = train_boundaries.sample_ws(G, opts)
    sample_s = sync_s(t0)
    if not (tuple(ws.shape) == (BOUNDARY_SAMPLES, cfg.num_ws, 512) and finite(ws)
            and bool((ws[:, 0] == G.mapping.w_avg).all())):
        raise SystemExit("train_boundaries: sampled latents have the wrong shape, are not "
                         "finite or not pseudo-aligned")
    n_scored = BOUNDARY_BATCHES * BOUNDARY_BATCH
    for attribute in SCORERS:
        opts.attribute = attribute
        scorer, select = train_boundaries.scorer_for(attribute, dev)
        with torch.no_grad():
            train_boundaries.score_ws(G, scorer, select, ws[:BOUNDARY_BATCH],
                                      BOUNDARY_BATCH)  # warm-up
            flrelu_cuda.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = train_boundaries.score_ws(G, scorer, select, ws[:n_scored], BOUNDARY_BATCH)
            secs = sync_s(t0)
            launches = dict(flrelu_cuda.launches)
            # One batch's scores on the card against the same scorer on the CPU,
            # on the card's renders.
            imgs = G.synthesize(ws[:BOUNDARY_BATCH])
            on_card = select(scorer(imgs))
            on_cpu = select(copy.deepcopy(scorer).cpu()(imgs.cpu()))
            err, scale, ok = close(on_card, on_cpu, SCORER_TOL)
            del imgs
        ok = ok and launches == {"filtered_lrelu_fwd": n_layers * BOUNDARY_BATCHES,
                                 "filtered_lrelu_bwd": 0, **NO_FIR} \
            and scores.shape == (n_scored, 1) and finite(scores)
        per_sample = secs * 1e3 / n_scored
        print(f"train_boundaries {attribute} ({type(scorer).__name__}): {BOUNDARY_BATCHES} "
              f"batches of {BOUNDARY_BATCH} bf16 renders at {cfg.img_resolution}^2, resized to "
              f"224^2 and scored: launches {launches}; scores {scores[:3, 0].round(4).tolist()}..., "
              f"card vs CPU on one batch: max abs err {err:.3e} (tol {SCORER_TOL:g} of max |ref| "
              f"{scale:.4g}) {'ok' if ok else 'FAIL'}")
        print(f"time train_boundaries {attribute}: {per_sample:.3f} ms per sample (render and "
              f"score); sampling {BOUNDARY_SAMPLES} z {1e3 * sample_s:.2f} ms; the CLI's "
              f"{BOUNDARY_ESTIMATE} samples: {BOUNDARY_ESTIMATE * per_sample / 1e3:.1f} s before "
              f"the fit {card}")
        if not ok:
            raise SystemExit(f"train_boundaries {attribute}: launches, scores or the card vs "
                             f"CPU check failed")
        del scorer
        torch.cuda.empty_cache()
    print("train_boundaries: the SVM fit (train_boundary, scikit-learn on the host) runs where "
          "scikit-learn is installed; the card's machine has none, so it is not run here")

    # (b) MapperCoach at SG3-R 1024: LevelsMapper, CLIP ViT-B/32, IR-SE-50.
    clip_model = CLIP(device=dev, generator=torch.Generator().manual_seed(163))
    facenet = IRSEBackbone(112, 50, "ir_se", drop_ratio=0.6,
                           generator=torch.Generator().manual_seed(164)).to(dev)
    seeded_batch_norms(facenet, 165)
    mopts = MapperTrainOptions()
    with tempfile.TemporaryDirectory() as tmp:
        bpe_vocabulary(Path(tmp) / "vocab.txt.gz")
        tokens = SimpleTokenizer(str(Path(tmp) / "vocab.txt.gz")).tokenize([mopts.description])
    coach = MapperCoach(mopts, cfg, decoder=G, clip_model=clip_model, facenet=facenet,
                        text_tokens=tokens, device=dev)
    gen = torch.Generator().manual_seed(166)
    with torch.no_grad():
        batches = [G.map(torch.randn((MAPPER_BATCH, cfg.z_dim), generator=gen).to(dev),
                         truncation_psi=0.7) for _ in range(MAPPER_STEPS)]
    history, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in batches:
        flrelu_cuda.reset_launches()
        t0 = time.perf_counter()
        history.append(coach.train_step(w))
        step_s.append(sync_s(t0))
        if dict(flrelu_cuda.launches) != {"filtered_lrelu_fwd": 2 * n_layers,
                                          "filtered_lrelu_bwd": n_layers, **NO_FIR}:
            raise SystemExit(f"mapper step {len(history)}: expected {2 * n_layers} forward and "
                             f"{n_layers} backward launches, saw {dict(flrelu_cuda.launches)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    frozen_grads = sum(p.grad is not None for m in (G, clip_model, facenet)
                       for p in m.parameters())
    ok = (all(math.isfinite(v) for h in history for v in h.values()) and frozen_grads == 0
          and coach.optimizer.param_groups[0]["step"] == MAPPER_STEPS
          and all(p in coach.optimizer.state for p in coach.net.mapper.parameters()))
    print(f"mapper coach, SG3-R 1024, batch {MAPPER_BATCH}, {MAPPER_STEPS} steps (Ranger lr "
          f"{mopts.learning_rate}, lambdas clip {mopts.clip_lambda}, id {mopts.id_lambda}, "
          f"latent l2 {mopts.latent_l2_lambda}; '{mopts.description}'): {2 * n_layers} forward "
          f"and {n_layers} backward launches a step; loss {history[0]['loss']:.6f} -> "
          f"{history[-1]['loss']:.6f} (clip {history[0]['loss_clip']:.6f} -> "
          f"{history[-1]['loss_clip']:.6f}, id {history[0]['loss_id']:.3e} -> "
          f"{history[-1]['loss_id']:.3e}, l2 {history[0]['loss_l2_latent']:.3e} -> "
          f"{history[-1]['loss_l2_latent']:.3e}); frozen networks' parameters with a "
          f"gradient: {frozen_grads} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("mapper coach: non-finite losses, a frozen network got gradients, or "
                         "Ranger did not step")
    steady = step_s[1:]
    print(f"time mapper step: {sum(steady) / len(steady):.4f} s per step (steps 2-"
          f"{MAPPER_STEPS}; {min(steady):.4f}-{max(steady):.4f}; the first {step_s[0]:.4f} s), "
          f"peak memory {peak:.3f} GiB {card}")

    # One step through the kernels against impl="ref" at batch 1, as phase 7's
    # PTI step: the plain composition keeps each layer's up-sampled
    # intermediates for the backward (by their shapes, 5.9 GB a tensor on L10
    # at batch 2). The losses, and every mapper gradient.
    w1 = batches[0][:1]
    runs = {impl: coach.loss_and_grads(w1, impl=impl) for impl in ("auto", "ref")}
    (m_k, g_k), (m_r, g_r) = runs["auto"], runs["ref"]
    loss_ok = all(abs(m_k[k] - v) <= MAPPER_LOSS_TOL[0] * abs(v) + MAPPER_LOSS_TOL[1]
                  for k, v in m_r.items())
    worst = max((float((g_k[k] - g).abs().max()) / float(g.abs().max()), k)
                for k, g in g_r.items() if float(g.abs().max()) > 0)
    print(f"mapper step, batch 1, kernels vs impl='ref': losses "
          + ", ".join(f"{k} {m_k[k]:.6g} / {v:.6g}" for k, v in m_r.items())
          + f" (tol {MAPPER_LOSS_TOL[0]:g} relative + 2^-20); {len(g_r)} mapper tensors, worst "
          f"max abs err / max |grad| {worst[0]:.3e} on {worst[1]} (tol {GRAD_TOL:g}) "
          f"{'ok' if loss_ok and worst[0] <= GRAD_TOL else 'FAIL'}")
    if not (loss_ok and worst[0] <= GRAD_TOL):
        raise SystemExit("mapper step through the kernels disagrees with impl='ref'")
    del runs, g_k, g_r
    torch.cuda.empty_cache()

    # One traced step: #1, #2, CLIP and IR-SE-50 on the device, the idle share.
    w = batches[-1]

    def traced_step():
        coach.optimizer.zero_grad(set_to_none=True)
        with record_function("forward"):
            loss, _ = coach.loss(w)
        with record_function("backward"):
            loss.backward()
        with record_function("ranger"):
            coach.optimizer.step()

    print_trace("mapper step, batch 2", device_trace(traced_step, ranges=[
        ("forward", None, None), ("backward", None, None), ("ranger", None, None),
        ("decoder synthesize (x and x_orig)", G, "synthesize"),
        ("clip (forward)", coach.clip_loss, "forward"),
        ("ir-se-50 (forward)", coach.id_loss, "extract_feats")]), card)
    if any(p.grad is not None for p in G.parameters()):
        raise SystemExit("the traced mapper step computed gradients of the generator's weights")
    del coach, clip_model, facenet, batches, w, w1
    torch.cuda.empty_cache()

    # (c) Kernel #2's fp32 route at batch 2, as the mapper's step runs it.
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, tc_bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    max_err = 0.0
    with torch.no_grad():
        for i, s in enumerate(layers):
            gen = torch.Generator(device=dev).manual_seed(1300 + i)
            x = torch.randn((2, s.in_size[1], s.in_size[0], s.out_channels), generator=gen,
                            device=dev) * 60
            b = torch.randn((s.out_channels,), generator=gen, device=dev)
            dy = torch.randn((2, s.out_size[1], s.out_size[0], s.out_channels), generator=gen,
                             device=dev)
            dx = bwd_kernel_call(s, dy, x, b)
            for n in (0, 1):
                ref = bwd_plain_call(s, dy[n:n + 1], x[n:n + 1], b)
                err = (dx[n:n + 1] - ref).abs()
                atol, rtol = FP32_TOL
                if not bool((err <= atol + rtol * ref.abs()).all()):
                    raise SystemExit(f"backward kernel, fp32 route, disagrees with the plain "
                                     f"version on {s.name}, batch 2, image {n}")
                max_err = max(max_err, float(err.max()))
                del ref, err
            nbytes, dy_up_flops, other_flops = flrelu_bwd_work(
                tuple(x.shape), tuple(dy.shape), s.up_factor, len(s.up_filter),
                s.down_filter.shape[0], s.down_filter.ndim == 2, x.element_size())
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = (dy_up_flops + other_flops) / FP32_FLOPS * 1e3
            # The tensor-core route's bound (its dy up pass at the bf16 rate) where
            # it applies: the radial layers; the fp32 route itself runs on the CUDA cores.
            tc_ops_ms = (other_flops / FP32_FLOPS + dy_up_flops / TC_FLOPS) * 1e3 \
                if s.down_filter.ndim == 2 else ops_ms
            k_ms = time_ms(lambda: bwd_kernel_call(s, dy, x, b), 10)

            def plain_batch():
                for n in range(2):
                    bwd_plain_call(s, dy[n:n + 1], x[n:n + 1], b)

            p_ms = time_ms(plain_batch, 2, warmup=1)
            bound, tc_bound = max(bytes_ms, ops_ms), max(bytes_ms, tc_ops_ms)
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound),
                           ("tc_bound_ms", tc_bound), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                tot[key] += v
            print(f"time bwd {s.name} fp32 route batch 2 (dy up pass on the CUDA cores): kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms at the fp32 rate "
                  f"({'operations' if ops_ms > bytes_ms else 'bytes'}: {nbytes / 1e6:.1f} MB, "
                  f"{(dy_up_flops + other_flops) / 1e9:.2f} GFLOP of which dy up pass "
                  f"{dy_up_flops / 1e9:.2f}), {tc_bound:.4f} ms with the dy up pass at the "
                  f"tensor-core rate {card}")
            del x, b, dy, dx
            torch.cuda.empty_cache()
    print(f"kernel #2, fp32 route, batch 2: {n_layers} layers against the plain version ok "
          f"(max abs err {max_err:.3e}); {tot['ms']:.4f} ms a step, plain {tot['plain_ms']:.4f} "
          f"ms, bound {tot['bound_ms']:.4f} ms at the fp32 rate, {tot['tc_bound_ms']:.4f} ms with "
          f"the radial layers' dy up pass at the tensor-core rate {card}")

    # (d) MTCNN's nets and the ID metric's IR-101, card vs CPU.
    mt = MTCNN(device=dev, generator=torch.Generator().manual_seed(167))
    mt_cpu = {name: copy.deepcopy(getattr(mt, name)).cpu() for name in ("pnet", "rnet", "onet")}
    img = torch.rand((1, 3, 1024, 1024), generator=torch.Generator().manual_seed(168)) * 255
    scales, length, m = [], 1024 * 12 / 20.0, 12 / 20.0
    while length > 12:  # MTCNN.detect's pyramid at min_face_size 20
        scales.append(m * 0.707 ** len(scales))
        length *= 0.707
    worst, t_ms = 0.0, 0.0
    with torch.no_grad():
        for scale in scales:
            side = int(math.ceil(1024 * scale))
            x = ((F.interpolate(img, size=(side, side), mode="bilinear", align_corners=False)
                  - 127.5) * 0.0078125).permute(0, 2, 3, 1).contiguous()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = mt.pnet(x.to(dev))
            t_ms += sync_s(t0) * 1e3
            for a, r in zip(got, mt_cpu["pnet"](x)):
                err = (a.cpu() - r).abs()
                worst = max(worst, float(err.max()))
                if not bool((err <= FP32_TOL[0] + FP32_TOL[1] * r.abs()).all()):
                    raise SystemExit(f"MTCNN P-Net on the card disagrees with the CPU at {side}^2")
        errs = {"pnet": worst}
        gen = torch.Generator().manual_seed(169)
        for name, side in (("rnet", 24), ("onet", 48)):
            x = torch.rand((MTCNN_BATCH, side, side, 3), generator=gen) * 2 - 1
            outs = zip(getattr(mt, name)(x.to(dev)), mt_cpu[name](x))
            errs[name] = 0.0
            for a, r in outs:
                err = (a.cpu() - r).abs()
                errs[name] = max(errs[name], float(err.max()))
                if not bool((err <= FP32_TOL[0] + FP32_TOL[1] * r.abs()).all()):
                    raise SystemExit(f"MTCNN {name} on the card disagrees with the CPU")
    print(f"mtcnn: P-Net on a 1024^2 image's {len(scales)}-scale pyramid "
          f"({', '.join(str(int(math.ceil(1024 * s))) for s in scales)}), {t_ms:.2f} ms on the "
          f"card; R-Net and O-Net at batch {MTCNN_BATCH}: card vs CPU max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol atol {FP32_TOL[0]:g} + rtol {FP32_TOL[1]:g}·|ref|) ok; detect and align "
          f"resize with Pillow, which the card's machine lacks: they run in the CPU tests {card}")
    id_opts = calc_id_loss_parallel.IDLossCalcOptions(device="cuda")
    net = calc_id_loss_parallel.build_facenet(id_opts, dev)
    seeded_batch_norms(net, 170)
    faces = torch.rand((ID_BATCH, 256, 256, 3), generator=torch.Generator().manual_seed(171)) * 2 - 1
    with torch.no_grad():
        calc_id_loss_parallel.embed_center_crop(net, faces.to(dev))  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = calc_id_loss_parallel.embed_center_crop(net, faces.to(dev))
        id_ms = sync_s(t0) * 1e3
        on_cpu = calc_id_loss_parallel.embed_center_crop(copy.deepcopy(net).cpu(), faces)
    err = (on_card.cpu() - on_cpu).abs()
    ok = bool((err <= FP32_TOL[0] + FP32_TOL[1] * on_cpu.abs()).all()) and \
        tuple(on_card.shape) == (ID_BATCH, 512) and finite(on_card)
    print(f"calc_id_loss_parallel IR-101 (ir, 100 layers) at batch {ID_BATCH}, centre crop of "
          f"256^2 pooled to 112^2: card vs CPU max abs err {float(err.max()):.3e} (tol atol "
          f"{FP32_TOL[0]:g} + rtol {FP32_TOL[1]:g}·|ref|) {'ok' if ok else 'FAIL'}; "
          f"{id_ms:.3f} ms a batch {card}")
    if not ok:
        raise SystemExit("the ID metric's IR-101 on the card disagrees with the CPU")
    del G, mt, mt_cpu, net
    torch.cuda.empty_cache()
    return max_err


RESTYLE_TRAIN_STEPS, RESTYLE_ACCUM = 8, 4  # two optimizer steps at the effective batch of 8
E4E_STEPS = 6


def restyle_training_phase(dev, card, n_layers):
    """Phase 14: ReStyle encoder training at full width, seeded weights. (a)
    `Coach.train` for pSp on SG3-R 1024 with the IR-SE-50 encoder at the
    upstream README's FFHQ settings (batch 2, 3 iterations, LPIPS 0.8, L2 1,
    ID 0.1, Ranger lr 1e-4, an effective batch of 8): 8 micro-steps, a
    validation batch at 4 and a checkpoint at 8; per micro-step 42 + 42
    launches, the encoder moving at micro-steps 4 and 8 only and its
    statistics at every one, no gradient in the decoder or the loss nets; the
    checkpoint through `load_encoder` gives the coach's codes to 0; s per
    micro-step and per optimizer step, peak memory, a traced micro-step with
    the optimizer's step. (b) e4e at `scripts/train_e4e.sh`'s recipe (256²,
    the ResNet-34 progressive encoder, w-disc 0.1, pools of 50, psi 0.7) with
    ``progressive_steps=[0, 2, 4]``, 6 micro-steps, R1 every 4. (c) one pSp
    micro-step at batch 1 through the kernels against ``impl="ref"``: the
    losses and every encoder gradient. Returns the peak memory of (a) in GiB."""
    import tempfile

    from torch.profiler import record_function

    from stylegan3_editing_tpu_torch.models.sg3 import build_synthesis_layout, sg3_r_config
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda
    from stylegan3_editing_tpu_torch.training import Coach, E4eTrainOptions, TrainOptions
    from stylegan3_editing_tpu_torch.utils.inference_utils import load_encoder

    def seeded(coach, seed):
        seeded_batch_norms(coach.model.encoder, seed)
        if coach.id_loss is not None:
            seeded_batch_norms(coach.id_loss, seed + 1)
        with torch.no_grad():
            z = torch.randn((256, coach.decoder_cfg.z_dim),
                            generator=torch.Generator().manual_seed(seed + 2))
            coach.model.decoder.mapping.w_avg.copy_(coach.model.decoder.map(z.to(dev))[:, 0]
                                                    .mean(0))
        coach.load_jax_state()  # latent_avg and the average image from the new w_avg
        return coach

    def faces(n, batch, seed):
        gen = torch.Generator().manual_seed(seed)
        return [tuple((torch.rand((batch, 256, 256, 3), generator=gen) * 2 - 1).numpy()
                      for _ in range(2)) for _ in range(n)]

    def instrument(coach, record):
        """Each micro-step of `Coach.train`: its launches (counts zeroed just
        before it), CUDA-synchronised seconds, whether the encoder's
        parameters and its batch-norm statistics moved."""
        step = coach.train_step
        params = [p for n, p in coach.trainable if n.startswith("encoder.")]
        stats = [b for n, b in coach.model.named_buffers() if n.startswith("encoder.")]

        def timed(batch, **kw):
            before = [p.detach().clone() for p in params]
            stats_before = [b.clone() for b in stats]
            torch.cuda.synchronize()
            flrelu_cuda.reset_launches()
            t0 = time.perf_counter()
            out = step(batch, **kw)
            torch.cuda.synchronize()
            record.append(dict(
                s=time.perf_counter() - t0, launches=dict(flrelu_cuda.launches), metrics=out,
                moved=any(not torch.equal(a, p) for a, p in zip(before, params)),
                stats_moved=all(not torch.equal(a, b) for a, b in zip(stats_before, stats))))
            return out

        coach.train_step = timed

    def finite(metrics):
        return all(math.isfinite(v) for v in metrics.values())

    # (a) pSp at full width, the README's FFHQ command.
    cfg = sg3_r_config(1024)
    with tempfile.TemporaryDirectory() as tmp:
        opts = TrainOptions(exp_dir=str(Path(tmp) / "psp"), encoder_type="BackboneEncoder",
                            batch_size=2, test_batch_size=2, n_iters_per_batch=3,
                            lpips_lambda=0.8, l2_lambda=1.0, id_lambda=0.1, w_norm_lambda=0.0,
                            moco_lambda=0.0, start_from_latent_avg=True, input_nc=6,
                            output_size=1024, learning_rate=1e-4, effective_batch_size=8,
                            board_interval=1, image_interval=0, val_interval=4,
                            save_interval=RESTYLE_TRAIN_STEPS, max_val_batches=1,
                            max_steps=RESTYLE_TRAIN_STEPS)
        t0 = time.perf_counter()
        coach = seeded(Coach(opts, cfg, device=dev), 180)
        build_s = time.perf_counter() - t0
        data = faces(RESTYLE_TRAIN_STEPS + 2, 2, seed=181)
        coach.loss_and_grads(data[-1])  # warm-up: one forward and backward, no update
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        record = []
        instrument(coach, record)
        t0 = time.perf_counter()
        coach.train(iter(data[:RESTYLE_TRAIN_STEPS]), val_batches_fn=lambda: iter(data[-2:-1]))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del coach.train_step  # the instance attribute: the method shows again
        want = {"filtered_lrelu_fwd": 3 * n_layers, "filtered_lrelu_bwd": 3 * n_layers,
                **NO_FIR}
        frozen = [p for m in (coach.model.decoder, *coach.loss_nets().values())
                  for p in m.parameters()]
        ok = (len(record) == RESTYLE_TRAIN_STEPS
              and all(r["launches"] == want for r in record)
              and [r["moved"] for r in record] == [i % RESTYLE_ACCUM == RESTYLE_ACCUM - 1
                                                   for i in range(RESTYLE_TRAIN_STEPS)]
              and all(r["stats_moved"] and finite(r["metrics"]) for r in record)
              and not any(p.requires_grad or p.grad is not None for p in frozen)
              and coach.optimizer.param_groups[0]["step"] == RESTYLE_TRAIN_STEPS // RESTYLE_ACCUM
              and coach.best_val_loss is not None and math.isfinite(coach.best_val_loss))
        first, last = record[0]["metrics"], record[-1]["metrics"]
        print(f"restyle coach pSp, SG3-R 1024 + IR-SE-50 at 256^2, batch 2, 3 iterations, "
              f"effective batch 8 (Ranger lr 1e-4; lambdas lpips 0.8, l2 1, id 0.1): "
              f"{RESTYLE_TRAIN_STEPS} micro-steps through Coach.train; launches per micro-step "
              f"{[r['launches']['filtered_lrelu_fwd'] for r in record]} forward and "
              f"{[r['launches']['filtered_lrelu_bwd'] for r in record]} backward (want "
              f"{3 * n_layers} each); encoder moved at micro-steps "
              f"{[i + 1 for i, r in enumerate(record) if r['moved']]}, statistics at every one: "
              f"{all(r['stats_moved'] for r in record)}; loss_total {first['loss_total']:.6f} -> "
              f"{last['loss_total']:.6f} (lpips {first['loss_lpips']:.6f} -> "
              f"{last['loss_lpips']:.6f}, l2 {first['loss_l2']:.6f} -> {last['loss_l2']:.6f}, "
              f"id {first['loss_id']:.3e} -> {last['loss_id']:.3e}); validation loss "
              f"{coach.best_val_loss:.6f}; frozen parameters with requires_grad or a gradient: "
              f"{sum(p.requires_grad or p.grad is not None for p in frozen)} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("restyle coach: launches, parameter or statistics movement, finite "
                             "losses, frozen parts or the optimizer's clock failed")
        micro = [r["s"] for r in record]
        print(f"time restyle coach micro-step: {sum(micro) / len(micro):.4f} s "
              f"({min(micro):.4f}-{max(micro):.4f}; after a warm-up forward and backward); "
              f"per optimizer step (4 micro-steps) {sum(micro) / 2:.4f} s; Coach.train "
              f"{train_s:.2f} s with the validation batch and two checkpoints; peak memory "
              f"{peak:.3f} GiB; coach built in {build_s:.2f} s {card}")

        # The step-8 checkpoint through the port's load_encoder: the coach's codes.
        ckpt = Path(opts.exp_dir) / "checkpoints" / f"iteration_{RESTYLE_TRAIN_STEPS}"
        model, _ = load_encoder(ckpt, device=dev)
        x6 = torch.from_numpy(np.concatenate([data[0][0], data[1][0]], axis=-1)).to(dev)
        with torch.no_grad():
            codes = [m.encode(x6, latent_avg=coach.latent_avg) for m in (model, coach.model)]
        err = float((codes[0] - codes[1]).abs().max())
        print(f"restyle checkpoint after micro-step {RESTYLE_TRAIN_STEPS} through load_encoder: "
              f"codes of one batch against the coach's, max abs err {err:.3e} (want 0) "
              f"{'ok' if err == 0 else 'FAIL'}")
        if err != 0:
            raise SystemExit("the coach's checkpoint does not reproduce its codes")
        del model, codes
        torch.cuda.empty_cache()

        # One traced micro-step with the optimizer's step (the 4th of a cycle).
        for batch in data[:RESTYLE_ACCUM - 1]:
            coach.train_step(batch)

        def traced():
            coach.train_step(data[RESTYLE_ACCUM - 1])

        print_trace("restyle coach micro-step with Ranger's step, batch 2", device_trace(
            traced, model=coach.model, ranges=[
                ("forward and backward", coach, "_loss_and_grads"),
                ("ir-se-50 (id loss, y_hat)", coach.id_loss, "extract_feats"),
                ("lpips (forward)", coach.lpips, "forward"),
                ("ranger", coach.optimizer, "step")]), card)
        if coach.accum_count != 0:
            raise SystemExit("the traced micro-step did not end an accumulation cycle")

        # (c) One micro-step at batch 1 through the kernels against impl="ref".
        # The plain composition keeps each layer's up-sampled intermediates for
        # the backward (~30 GB a 1024^2 decode at batch 1), so the plain run
        # recomputes each decode in the backward (activation checkpointing):
        # the same plain ops on the same inputs, the same gradient.
        from torch.utils.checkpoint import checkpoint

        one = tuple(b[:1] for b in data[0])
        flrelu_cuda.reset_launches()
        runs = {"auto": coach.loss_and_grads(one, impl="auto")}
        auto_launches = dict(flrelu_cuda.launches)
        decode = coach.model.decode
        coach.model.decode = lambda codes, **kw: checkpoint(decode, codes, use_reentrant=False,
                                                            **kw)
        try:
            flrelu_cuda.reset_launches()
            runs["ref"] = coach.loss_and_grads(one, impl="ref")
            ref_launches = dict(flrelu_cuda.launches)
        finally:
            del coach.model.decode
        (m_k, g_k), (m_r, g_r) = runs["auto"], runs["ref"]
        loss_ok = all(abs(m_k[k] - v) <= MAPPER_LOSS_TOL[0] * abs(v) + MAPPER_LOSS_TOL[1]
                      for k, v in m_r.items())
        # The encoder's gradient is held at its own scale (its largest |entry|):
        # the train-mode batch norms cancel some tensors' gradients to rounding
        # noise (a shortcut BN's bias feeding only batch norms has a gradient of
        # 0 analytically), which any change of summation order redraws. Each
        # tensor's error over its own max is printed too.
        scale = max(float(g.abs().max()) for g in g_r.values())
        errs = {k: float((g_k[k] - g).abs().max()) for k, g in g_r.items()}
        worst = max((errs[k] / float(g.abs().max()), k) for k, g in g_r.items()
                    if float(g.abs().max()) > 0)
        ok = (loss_ok and max(errs.values()) <= GRAD_TOL * scale
              and ref_launches == {**FLRELU, **NO_FIR}
              and auto_launches == {"filtered_lrelu_fwd": 3 * n_layers,
                                    "filtered_lrelu_bwd": 3 * n_layers, **NO_FIR})
        print(f"restyle micro-step, batch 1, 3 iterations, kernels vs impl='ref': losses "
              + ", ".join(f"{k} {m_k[k]:.6g} / {v:.6g}" for k, v in m_r.items())
              + f" (tol {MAPPER_LOSS_TOL[0]:g} relative + 2^-20); {len(g_r)} encoder tensors, "
              f"max abs err {max(errs.values()):.3e} against the gradient's largest |entry| "
              f"{scale:.3e} (tol {GRAD_TOL:g} of it); per tensor, worst max abs err / its max "
              f"|grad| {worst[0]:.3e} on {worst[1]} (whose max |grad| is "
              f"{float(g_r[worst[1]].abs().max()) / scale:.3e} of the scale) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the restyle micro-step through the kernels disagrees with "
                             "impl='ref'")
        del coach, runs, g_k, g_r
        torch.cuda.empty_cache()

        # (b) e4e at scripts/train_e4e.sh's recipe, progressive stages added.
        cfg256 = sg3_r_config(256)
        n256 = sum(s.up_filter is not None for s in build_synthesis_layout(cfg256).layers)
        eopts = E4eTrainOptions(
            exp_dir=str(Path(tmp) / "e4e"), encoder_type="ResNetProgressiveBackboneEncoder",
            batch_size=2, n_iters_per_batch=3, lpips_lambda=0.8, l2_lambda=1.0, id_lambda=0.1,
            w_discriminator_lambda=0.1, use_w_pool=True, w_pool_size=50, truncation_psi=0.7,
            input_nc=6, output_size=256, progressive_steps=[0, 2, 4], d_reg_every=4)
        e4e = seeded(Coach(eopts, cfg256, device=dev), 190)
        erecord, stages = [], []
        instrument(e4e, erecord)
        for batch in faces(E4E_STEPS, 2, seed=191):
            stages.append(e4e._current_stage())
            e4e.train_step(batch)
        del e4e.train_step
        needed = {"discriminator_loss", "encoder_discriminator_loss", "total_delta_loss"}
        r1_at = [i for i, r in enumerate(erecord) if "discriminator_r1_loss" in r["metrics"]]
        want = {"filtered_lrelu_fwd": 3 * n256, "filtered_lrelu_bwd": 3 * n256, **NO_FIR}
        ok = (all(needed <= set(r["metrics"]) and finite(r["metrics"]) for r in erecord)
              and r1_at == [0, 4] and stages == [0, 0, 1, 1, 2, 2]
              and all(r["launches"] == want for r in erecord))
        emicro = [r["s"] for r in erecord]
        print(f"restyle coach e4e (scripts/train_e4e.sh: ResNet-34 progressive, 256^2, w-disc "
              f"0.1, pools of 50, psi 0.7, batch 2, 3 iterations; progressive_steps [0, 2, 4], "
              f"R1 every 4): {E4E_STEPS} micro-steps, stages {stages}, R1 at micro-steps "
              f"{[i + 1 for i in r1_at]}, discriminator_loss "
              f"{[round(r['metrics']['discriminator_loss'], 4) for r in erecord]}, "
              f"total_delta_loss {[round(r['metrics']['total_delta_loss'], 4) for r in erecord]}, "
              f"launches per micro-step {erecord[0]['launches']['filtered_lrelu_fwd']} + "
              f"{erecord[0]['launches']['filtered_lrelu_bwd']} ({n256} a decode) "
              f"{'ok' if ok else 'FAIL'}")
        print(f"time restyle coach e4e micro-step: {sum(emicro[1:]) / (len(emicro) - 1):.4f} s "
              f"(micro-steps 2-{E4E_STEPS}; the first {emicro[0]:.4f} s) {card}")
        if not ok:
            raise SystemExit("restyle e4e coach: metrics, R1, stages or launches failed")
        del e4e
        torch.cuda.empty_cache()
    return peak


EVAL_TOL = 1e-4  # LPIPS and MS-SSIM, card vs CPU, of max |ref|: fp32 sum order (SCORER_TOL's)
PAD_TOL = 1e-5   # a padded reference slot's contents, of max |image|: nothing but rounding
EVAL_BATCH, EVAL_PAIRS = 8, 16
ANIMATION_FRAMES, ANIMATION_BATCH = 25, 8      # create_inversion_animation's defaults
FIDELITY_NUM, FIDELITY_ITERS = 4, 3            # eval_inversion_fidelity's defaults
SETGAN_BATCH, SETGAN_REFS, SETGAN_CANDS = 16, (4, 7), (1, 4)  # train_setgan_stem.sh
PLAIN_CHUNK = 8  # images per plain-version call in phase 15's layer rows


def irse_reference_state(n_styles: int, seed: int) -> dict:
    """A ReStyle-e4e IR-SE-50 encoder's state dict in the reference's naming
    (``input_layer``, ``body.N.res_layer``/``shortcut_layer``, ``styles.J``),
    from seeded weights: convs and linears normal with std 1/sqrt(fan_in),
    batch norms with non-trivial statistics, PReLU slopes near 0.25."""
    from stylegan3_editing_tpu_torch.models.backbones.irse import get_blocks

    gen = torch.Generator().manual_seed(seed)
    state = {}

    def arr(*shape):
        z = torch.randn(shape, generator=gen)
        return z / math.sqrt(math.prod(shape[1:])) if len(shape) in (2, 4) else z

    def bn(prefix, c):
        state[f"{prefix}.weight"] = 1 + 0.1 * arr(c)
        state[f"{prefix}.bias"] = 0.1 * arr(c)
        state[f"{prefix}.running_mean"] = 0.1 * arr(c)
        state[f"{prefix}.running_var"] = 0.5 + arr(c).abs()
        state[f"{prefix}.num_batches_tracked"] = torch.tensor(3)

    state["input_layer.0.weight"] = arr(64, 6, 3, 3)  # image and average image
    bn("input_layer.1", 64)
    state["input_layer.2.weight"] = 0.25 + 0.05 * arr(64)
    for idx, spec in enumerate(s for stage in get_blocks(50) for s in stage):
        p = f"body.{idx}"
        if spec.in_channel != spec.depth:
            state[f"{p}.shortcut_layer.0.weight"] = arr(spec.depth, spec.in_channel, 1, 1)
            bn(f"{p}.shortcut_layer.1", spec.depth)
        bn(f"{p}.res_layer.0", spec.in_channel)
        state[f"{p}.res_layer.1.weight"] = arr(spec.depth, spec.in_channel, 3, 3)
        state[f"{p}.res_layer.2.weight"] = 0.25 + 0.05 * arr(spec.depth)
        state[f"{p}.res_layer.3.weight"] = arr(spec.depth, spec.depth, 3, 3)
        bn(f"{p}.res_layer.4", spec.depth)
        state[f"{p}.res_layer.5.fc1.weight"] = arr(spec.depth // 16, spec.depth, 1, 1)
        state[f"{p}.res_layer.5.fc2.weight"] = arr(spec.depth, spec.depth // 16, 1, 1)
    for j in range(n_styles):
        for k in range(4):
            state[f"styles.{j}.convs.{2 * k}.weight"] = arr(512, 512, 3, 3)
            state[f"styles.{j}.convs.{2 * k}.bias"] = 0.1 * arr(512)
        state[f"styles.{j}.linear.weight"] = arr(512, 512)
        state[f"styles.{j}.linear.bias"] = 0.1 * arr(512)
    return state


class RenderedClasses:
    """The duck-typed dataset `ImageMultiSetGenerator` samples: classes of
    seeded renders held in memory (the card's machine has no Pillow)."""

    def __init__(self, images: np.ndarray, n_classes: int):
        per = images.shape[0] // n_classes
        self.images, self.resolution = images, images.shape[1]
        self.classes = list(range(n_classes))
        self.class_to_paths = {c: list(range(c * per, (c + 1) * per)) for c in self.classes}

    def load(self, path) -> np.ndarray:
        return self.images[path]


def evaluation_setgan_phase(dev, card, layers, layer_call, kernel_call) -> float:
    """Phase 15: (a) the evaluation side: LPIPS on its three trunks and
    MS-SSIM card vs CPU, `calc_losses_on_images`' metric in its three modes,
    `create_inversion_animation`'s render loop from a numpy-format
    checkpoint, `eval_inversion_fidelity`'s port half at its defaults; (b)
    the SetGAN generator at `train_setgan_stem.sh`'s recipe at 256²: a
    forward as the trainer's G step makes it, timed and traced, kernel #1
    per layer of SG3-T 256 at batch 64 and 1, the fp32 forward against
    ``impl="ref"``, the padded-slot and the sampler's seed gates, and the
    pretrained recipe's ReStyle-encoder mode. Returns #1's largest error
    against its plain version."""
    import dataclasses
    import tempfile

    from stylegan3_editing_tpu_torch.criteria import LPIPS, msssim
    from stylegan3_editing_tpu_torch.models.encoders import RestyleNet
    from stylegan3_editing_tpu_torch.models.sg3 import (build_synthesis_layout, sg3_r_config,
                                                        sg3_t_config)
    from stylegan3_editing_tpu_torch.models.sg3.from_jax import to_jax_variables
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda
    from stylegan3_editing_tpu_torch.runtime.checkpoint import save_pytree
    from stylegan3_editing_tpu_torch.scripts import (calc_losses_on_images,
                                                     create_inversion_animation,
                                                     eval_inversion_fidelity as fid)
    from stylegan3_editing_tpu_torch.setgan import ImageMultiSetGenerator, SetGAN
    from stylegan3_editing_tpu_torch.training.options import E4eTrainOptions
    from stylegan3_editing_tpu_torch.utils.common import make_transform
    from stylegan3_editing_tpu_torch.utils.inference_utils import load_encoder

    def finite(*ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    max_err = 0.0
    # (a) LPIPS on each trunk and MS-SSIM: card vs CPU, ms per image.
    gen = torch.Generator().manual_seed(150)
    x = torch.rand((EVAL_BATCH, 256, 256, 3), generator=gen) * 2 - 1
    y = (x + 0.3 * torch.randn(x.shape, generator=gen)).clamp(-1, 1)
    xd, yd = x.to(dev), y.to(dev)
    with torch.inference_mode():
        for net in ("alex", "vgg", "squeeze", "msssim"):
            if net == "msssim":
                cpu_fn = gpu_fn = lambda a, b: msssim(a, b, size_average=False)
            else:
                cpu_fn = LPIPS(net, device="cpu",
                               generator=torch.Generator().manual_seed(151)).eval().per_image
                gpu_fn = LPIPS(net, device=dev,
                               generator=torch.Generator().manual_seed(151)).eval().per_image
            ref, got = cpu_fn(x, y), gpu_fn(xd, yd).cpu()
            err, tol = float((got - ref).abs().max()), EVAL_TOL * float(ref.abs().max())
            ms = time_ms(lambda: gpu_fn(xd, yd), 5) / EVAL_BATCH
            print(f"evaluation {net}: batch {EVAL_BATCH} at 256^2, card vs CPU max abs err "
                  f"{err:.3e} (tol {tol:.3e}: {EVAL_TOL:g} of max |ref| "
                  f"{float(ref.abs().max()):.4g}); mean {float(got.mean()):.6f}; "
                  f"{ms:.4f} ms per image {card}")
            if not (err <= tol and finite(got)):
                raise SystemExit(f"{net} on the card disagrees with the CPU")
            del cpu_fn, gpu_fn
        torch.cuda.empty_cache()

        # calc_losses_on_images' metric: two directories of 16 pairs, batches of 4.
        pairs = []
        for d, noise in enumerate((0.2, 0.05)):
            g = torch.Generator().manual_seed(152 + d)
            gt = torch.rand((EVAL_PAIRS, 256, 256, 3), generator=g) * 2 - 1
            pairs.append(((gt + noise * torch.randn(gt.shape, generator=g)).clamp(-1, 1), gt))
        batch_size = calc_losses_on_images.LossCalcOptions().batch_size
        for mode in calc_losses_on_images.MODES:
            metrics = {d: calc_losses_on_images.make_metric(mode, d) for d in ("cpu", dev)}
            line, ms_total = [], 0.0
            for d, (out, gt) in enumerate(pairs):
                scores, refs = [], []
                for n in range(0, EVAL_PAIRS, batch_size):
                    a, b = out[n:n + batch_size], gt[n:n + batch_size]
                    s, sec = sync_s(lambda: metrics[dev](a.to(dev), b.to(dev)))
                    ms_total += sec * 1e3
                    scores.append(s.cpu())
                    refs.append(metrics["cpu"](a, b))
                s, r = torch.cat(scores), torch.cat(refs)
                err, tol = float((s - r).abs().max()), EVAL_TOL * float(r.abs().max())
                if not (finite(s) and err <= tol):
                    raise SystemExit(f"calc_losses_on_images {mode}: the card disagrees with "
                                     f"the CPU ({err:.3e} > {tol:.3e}) or a score is not finite")
                line.append(f"step_{d + 1} {float(s.mean()):.6f} ± {float(s.std(unbiased=False)):.6f}"
                            f" (n {len(s)}, card vs CPU {err:.3e})")
            print(f"calc_losses_on_images {mode}: {'; '.join(line)}; "
                  f"{ms_total / (2 * EVAL_PAIRS):.4f} ms per pair {card}")
            del metrics
        del pairs, x, y, xd, yd
        torch.cuda.empty_cache()

    # create_inversion_animation from a numpy-format e4e checkpoint (IR-SE-50, SG3-R 1024).
    cfg_r = sg3_r_config(1024)
    with tempfile.TemporaryDirectory() as tmp:
        model = RestyleNet(cfg_r, "ProgressiveBackboneEncoder", n_styles=cfg_r.num_ws,
                           device=dev, generator=torch.Generator().manual_seed(10))
        seeded_batch_norms(model.encoder, 20)
        with torch.no_grad():
            z = torch.randn((256, cfg_r.z_dim), generator=torch.Generator().manual_seed(30))
            model.decoder.mapping.w_avg.copy_(model.decoder.map(z.to(dev))[:, 0].mean(0))
        ckpt = Path(tmp) / "e4e_ckpt"
        _, save_s = sync_s(lambda: save_pytree(ckpt, {"variables": to_jax_variables(model)}, {
            "opts": dataclasses.asdict(E4eTrainOptions(output_size=1024)), "is_e4e": True}))
        del model
        torch.cuda.empty_cache()
        loaded, _ = load_encoder(ckpt, device=dev)
    decoder = loaded.decoder
    w_avg = decoder.mapping.w_avg.cpu().numpy()
    rng = np.random.RandomState(155)
    latents = [w_avg + 0.5 * rng.randn(cfg_r.num_ws, 512).astype(np.float32) for _ in range(3)]
    transforms = [make_transform((0.05 * (i - 1), -0.03 * i), 5.0 * (i - 1)).astype(np.float32)
                  for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    flrelu_cuda.reset_launches()
    frames, sec = sync_s(lambda: create_inversion_animation.render_animation(
        decoder, latents, transforms, ANIMATION_FRAMES, ANIMATION_BATCH))
    launches = dict(flrelu_cuda.launches)
    chunks = 2 * math.ceil(ANIMATION_FRAMES / ANIMATION_BATCH)
    print(f"create_inversion_animation: checkpoint written in {save_s:.2f} s and read by "
          f"load_encoder; 3 latents, {len(frames)} frames {frames[0].shape} {frames[0].dtype} "
          f"in {chunks} chunks of up to {ANIMATION_BATCH}: launches {launches}; "
          f"{sec * 1e3 / len(frames):.4f} ms per frame, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB {card}")
    if launches != {"filtered_lrelu_fwd": len(layers) * chunks, "filtered_lrelu_bwd": 0,
                    **NO_FIR}:
        raise SystemExit("expected 14 forward launches per animation chunk")
    res = cfg_r.img_resolution
    if len(frames) != 2 * ANIMATION_FRAMES or frames[0].shape != (res, res, 3) or \
            frames[0].dtype != np.uint8 or np.array_equal(frames[0], frames[-1]):
        raise SystemExit("wrong animation frames")
    del frames
    err = layer_rows(dev, card, layers, layer_call, kernel_call, 1, False, 156,
                     "animation's remainder chunk")[2]
    max_err = max(max_err, err)

    # eval_inversion_fidelity's port half at its defaults, from reference-format states.
    cfg_f = sg3_r_config(1024, use_bf16=False)
    gen_state = {k: v.numpy() for k, v in reference_state(decoder).items()}
    enc_state = {k: v.numpy() for k, v in irse_reference_state(cfg_f.num_ws, 157).items()}
    del loaded, decoder
    torch.cuda.empty_cache()
    model = fid.port_restyle_from_states(gen_state, enc_state, cfg_f, device=dev)
    lpips = LPIPS("alex", device=dev, generator=torch.Generator().manual_seed(2)).eval()
    del gen_state, enc_state
    flrelu_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    def fidelity_run():
        targets = fid.synthesize_targets(model, FIDELITY_NUM, 0)
        recon, _, _ = fid.invert(model, targets, FIDELITY_ITERS)
        return recon, fid.lpips_per_image(lpips, recon, targets)

    (recon, lp), sec = sync_s(fidelity_run)
    launches = dict(flrelu_cuda.launches)
    print(f"eval_inversion_fidelity (port half): SG3-R 1024 fp32, IR-SE-50 e4e, "
          f"{FIDELITY_NUM} targets, {FIDELITY_ITERS} iterations: {sec:.4f} s a run, launches "
          f"{launches}, reconstructions {tuple(recon.shape)}, LPIPS-alex of each "
          f"{np.array2string(lp, precision=6)} (mean {float(np.mean(lp)):.6f}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB {card}")
    if launches != {"filtered_lrelu_fwd": len(layers) * (2 + FIDELITY_ITERS),
                    "filtered_lrelu_bwd": 0, **NO_FIR}:
        raise SystemExit("expected 14 forward launches per decode of the fidelity run")
    if tuple(recon.shape) != (FIDELITY_NUM, 256, 256, 3) or not (
            finite(recon) and np.isfinite(lp).all()):
        raise SystemExit("eval_inversion_fidelity: wrong or non-finite reconstructions")
    del model, lpips, recon
    torch.cuda.empty_cache()

    # (b) The SetGAN generator at train_setgan_stem.sh's recipe, RES = 256.
    cfg_t = sg3_t_config(256, channel_base=16384, channel_max=256, num_layers=7)
    t_layers = [s for s in build_synthesis_layout(cfg_t).layers if s.up_filter is not None]
    G = SetGAN(cfg_t, n_heads=4, attn_layers=2, mean_center=False, restyle_mode="none",
               encoder_type="ProgressiveBackboneEncoder", remat_encoder=True, device=dev,
               generator=torch.Generator().manual_seed(160)).eval()
    seeded_batch_norms(G.encoder, 161)
    with torch.no_grad():
        z = torch.randn((256, cfg_t.z_dim), generator=torch.Generator().manual_seed(162))
        G.decoder.mapping.w_avg.copy_(G.decoder.map(z.to(dev))[:, 0].mean(0))
        pool = G.decoder(torch.randn((18, cfg_t.z_dim), generator=torch.Generator().manual_seed(
            163)).to(dev), truncation_psi=0.7).float().cpu().numpy()
    data = RenderedClasses(pool, 3)

    def sampler():
        return ImageMultiSetGenerator(data, SETGAN_BATCH, reference_range=SETGAN_REFS,
                                      candidate_range=SETGAN_CANDS, data_augmentation=True,
                                      seed=0)

    t0 = time.perf_counter()
    batch = sampler().sample_batch()
    sample_s = time.perf_counter() - t0
    again = sampler().sample_batch()
    same = all(np.array_equal(batch[k], again[k]) for k in batch) and sorted(batch) == \
        sorted(again)
    print(f"setgan sampler: batch {SETGAN_BATCH}, references {batch['ref_mask'].sum(1).tolist()}"
          f" of {SETGAN_REFS[1]}, candidates {batch['cand_mask'].sum(1).tolist()} of "
          f"{SETGAN_CANDS[1]}, set-consistent flips and rotations, {sample_s:.3f} s on the host; "
          f"the same batch again from the seed: {same}")
    if not same:
        raise SystemExit("ImageMultiSetGenerator gave another batch from the same seed")
    ref = torch.from_numpy(batch["reference"]).to(dev)
    mask = torch.from_numpy(batch["ref_mask"]).to(dev)
    zs = torch.randn((SETGAN_BATCH, SETGAN_CANDS[1], cfg_t.z_dim),
                     generator=torch.Generator().manual_seed(164)).to(dev)
    latent_avg = G.decoder.mapping.w_avg.clone()
    n_valid = int(batch["cand_mask"].sum())

    def run_g():
        return G(ref, zs, latent_avg=latent_avg, ref_mask=mask, return_latents=True)

    with torch.no_grad():
        flrelu_cuda.reset_launches()
        imgs, ws = run_g()
        torch.cuda.synchronize()
        launches = dict(flrelu_cuda.launches)
        print(f"setgan forward: references {tuple(ref.shape)}, z {tuple(zs.shape)} -> images "
              f"{tuple(imgs.shape)}, latents {tuple(ws.shape)}; launches {launches} per call")
        if launches != {"filtered_lrelu_fwd": len(t_layers), "filtered_lrelu_bwd": 0,
                        **NO_FIR}:
            raise SystemExit(f"expected {len(t_layers)} forward launches per SetGAN call")
        res_t = cfg_t.img_resolution
        if tuple(imgs.shape) != (SETGAN_BATCH, SETGAN_CANDS[1], res_t, res_t, 3) or not finite(
                imgs, ws):
            raise SystemExit("SetGAN: wrong or non-finite images")
        del imgs, ws
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(run_g, 3, warmup=1)
        print(f"setgan forward: {ms:.4f} ms a call, {n_valid * 1e3 / ms:.4f} candidate images/s "
              f"({n_valid} valid of {SETGAN_BATCH * SETGAN_CANDS[1]} slots), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB {card}")
        t = device_trace(run_g, ranges=[("encoder", G.encoder, "forward"),
                                        ("style_attn", G.style_attn, "forward"),
                                        ("decoder", G.decoder, "synthesize")])
        print_trace("setgan forward", t, card)

        # Gates at batch 2: fp32 through the kernels vs impl="ref"; padded slots.
        r2, m2, z2 = ref[:2].clone(), mask[:2].clone(), zs[:2]
        m2[:, -2:] = False
        r2[~m2] = 0
        a = G(r2, z2, latent_avg=latent_avg, ref_mask=m2, force_fp32=True)
        r_ = G(r2, z2, latent_avg=latent_avg, ref_mask=m2, force_fp32=True, impl="ref")
        img_err = float((a - r_).abs().max())
        other = r2.clone()
        other[~m2] = torch.from_numpy(pool[:1]).to(dev).flip(2)
        p = G(other, z2, latent_avg=latent_avg, ref_mask=m2, force_fp32=True)
        pad_err = float((p - a).abs().max())
        moved = float((G(other, z2, latent_avg=latent_avg, ref_mask=torch.ones_like(m2),
                         force_fp32=True) - a).abs().max())
        scale = float(r_.abs().max())
        print(f"setgan batch 2 fp32, kernels vs impl='ref': max abs err {img_err:.3e} (tol "
              f"{IMAGE_TOL:g}, max |ref| {scale:.4g}); padded reference slots filled with "
              f"another image: max abs change {pad_err:.3e} (tol {PAD_TOL * scale:.3e}); the "
              f"same slots unmasked move it by {moved:.3e}")
        if not (img_err <= IMAGE_TOL and pad_err <= PAD_TOL * scale and moved > PAD_TOL * scale):
            raise SystemExit("SetGAN: the kernels disagree with impl='ref', or a padded slot "
                             "changed a candidate")
        del a, r_, p, other

    # Kernel #1 on SG3-T 256's layers: batch 64 (B·C) with the plain version's
    # time, and batch 1 (the ReStyle-mode average render).
    err = layer_rows(dev, card, t_layers, layer_call, kernel_call,
                     SETGAN_BATCH * SETGAN_CANDS[1], False, 170, "SG3-T 256",
                     plain_chunk=PLAIN_CHUNK)[2]
    max_err = max(max_err, err, layer_rows(dev, card, t_layers, layer_call, kernel_call, 1,
                                           False, 180, "SG3-T 256 average render")[2])
    del G
    torch.cuda.empty_cache()

    # The pretrained recipe: ReStyle-encoder mode, one iteration, mean-centred.
    G2 = SetGAN(cfg_t, n_heads=4, attn_layers=2, mean_center=True, restyle_mode="encoder",
                restyle_iters=1, encoder_type="ProgressiveBackboneEncoder", device=dev,
                generator=torch.Generator().manual_seed(165)).eval()
    seeded_batch_norms(G2.encoder, 166)
    with torch.no_grad():
        z = torch.randn((256, cfg_t.z_dim), generator=torch.Generator().manual_seed(167))
        G2.decoder.mapping.w_avg.copy_(G2.decoder.map(z.to(dev))[:, 0].mean(0))
        flrelu_cuda.reset_launches()
        (imgs, ws), sec = sync_s(lambda: G2(ref, zs, latent_avg=G2.decoder.mapping.w_avg,
                                             ref_mask=mask, return_latents=True))
        launches = dict(flrelu_cuda.launches)
    print(f"setgan restyle_mode encoder, 1 iteration, mean-centred: images {tuple(imgs.shape)}, "
          f"launches {launches} (the batch-1 average render and the batch-"
          f"{SETGAN_BATCH * SETGAN_CANDS[1]} decode), {sec * 1e3:.4f} ms, finite "
          f"{finite(imgs, ws)} {card}")
    if launches != {"filtered_lrelu_fwd": 2 * len(t_layers), "filtered_lrelu_bwd": 0,
                    **NO_FIR} or not finite(imgs, ws):
        raise SystemExit("SetGAN restyle mode: wrong launches or non-finite outputs")
    del G2, imgs, ws, ref, zs
    torch.cuda.empty_cache()
    return max_err


SETGAN_D_LATENT = 128      # train_setgan_stem.sh's --d_latent
SETGAN_TIMED_STEPS = 3     # timed train_steps after one warm-up


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().view(torch.int32) if t.element_size() == 4 else t.detach()


def _to(tree, device):
    """A nest of dicts of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _bwd_rows(dev, card, layers, bwd_kernel_call, bwd_plain_call, batch, seed, what):
    """Kernel #2 on ``layers`` at ``batch`` in each layer's dtype (x scaled
    by 60 so that the clamp bites): dx against the plain version on every
    image (in calls of `PLAIN_CHUNK`), db = Σ dx within `DB_TOL`, timed
    beside the plain version and the bound (`flrelu_bwd_work`, every FLOP at
    the fp32 rate: these separable layers run their dy up pass on the CUDA
    cores). Returns (ms, bound ms, plain ms, max abs err)."""
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda

    err_max, tot = 0.0, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    with torch.no_grad():
        for i, s in enumerate(layers):
            dtype = torch.bfloat16 if s.use_bf16 else torch.float32
            gen = torch.Generator(device=dev).manual_seed(seed + i)
            x = (torch.randn((batch, s.in_size[1], s.in_size[0], s.out_channels), generator=gen,
                             device=dev) * 60).to(dtype)
            b = torch.randn((s.out_channels,), generator=gen, device=dev).to(dtype)
            out_h, out_w = (flrelu_cuda.output_size(side, s.up_factor, p0, p1, len(s.up_filter),
                                                    s.down_filter.shape[0])
                            for side, p0, p1 in ((s.in_size[1], s.padding[2], s.padding[3]),
                                                 (s.in_size[0], s.padding[0], s.padding[1])))
            dy = torch.randn((batch, out_h, out_w, s.out_channels), generator=gen,
                             device=dev).to(dtype)
            dx = bwd_kernel_call(s, dy, x, b)
            atol, rtol = BF16_TOL if s.use_bf16 else FP32_TOL
            db_ref = torch.zeros(s.out_channels, device=dev)
            for n in range(0, batch, PLAIN_CHUNK):
                ref = bwd_plain_call(s, dy[n:n + PLAIN_CHUNK].float(),
                                     x[n:n + PLAIN_CHUNK].float(), b.float())
                err = (dx[n:n + PLAIN_CHUNK].float() - ref).abs()
                if not bool((err <= atol + rtol * ref.abs()).all()):
                    raise SystemExit(f"backward kernel disagrees with the plain version on "
                                     f"{s.name}, {what} batch {batch}, images {n}..")
                err_max = max(err_max, float(err.max()))
                db_ref += ref.sum((0, 1, 2))
                del ref, err
            db_err = float((dx.float().sum((0, 1, 2)) - db_ref).abs().max())
            db_tol = DB_TOL[s.use_bf16] * float(db_ref.abs().max())
            if db_err > db_tol:
                raise SystemExit(f"db of the backward kernel disagrees on {s.name}: "
                                 f"{db_err:.3e} > {db_tol:.3e}")
            k_ms = time_ms(lambda: bwd_kernel_call(s, dy, x, b), 5)

            def plain_batch():
                for n in range(0, batch, PLAIN_CHUNK):
                    bwd_plain_call(s, dy[n:n + PLAIN_CHUNK], x[n:n + PLAIN_CHUNK], b)

            p_ms = time_ms(plain_batch, 1, warmup=0)  # the check above warmed it
            nbytes, dy_up_flops, other_flops = flrelu_bwd_work(
                tuple(x.shape), tuple(dy.shape), s.up_factor, len(s.up_filter),
                s.down_filter.shape[0], s.down_filter.ndim == 2, x.element_size())
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = (dy_up_flops + other_flops) / FP32_FLOPS * 1e3
            bound = max(bytes_ms, ops_ms)
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound)):
                tot[key] += v
            print(f"time bwd {s.name} {str(dtype)[6:]} {what} batch {batch}, up {s.up_factor}, "
                  f"{len(s.up_filter)}-tap up, {s.down_filter.shape[0]}-tap separable down, "
                  f"{s.out_channels} channels: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({'operations' if ops_ms > bytes_ms else 'bytes'}: "
                  f"{nbytes / 1e6:.1f} MB, {(dy_up_flops + other_flops) / 1e9:.2f} GFLOP); db "
                  f"max abs err {db_err:.3e} (tol {db_tol:.3e}) {card}")
            del x, b, dy, dx
            torch.cuda.empty_cache()
    print(f"kernel #2, {what} batch {batch}: {len(layers)} layers against the plain version ok "
          f"(max abs err {err_max:.3e}); {tot['ms']:.4f} ms a G step's backward, alone, plain "
          f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms {card}")
    return tot["ms"], tot["bound_ms"], tot["plain_ms"], err_max


def _group_check(what, group, got, want, loss_got, loss_want, tol=GRAD_TOL):
    """Losses within `MAPPER_LOSS_TOL`, every gradient within ``tol`` of the
    group's largest |entry| of ``want``."""
    atol_rel, floor = MAPPER_LOSS_TOL
    scale = max(float(v.abs().max()) for v in want.values())
    worst = max((float((got[k] - v).abs().max()), k) for k, v in want.items())
    print(f"{what} {group} step, batch 2 fp32: loss {loss_got:.8f} vs {loss_want:.8f}; "
          f"{len(want)} gradients, worst max abs err {worst[0]:.3e} on {worst[1]} (tol {tol:g} "
          f"of the group's max |grad| {scale:.4g})")
    return abs(loss_got - loss_want) <= atol_rel * abs(loss_want) + floor and \
        worst[0] <= tol * scale


def _steps_vs(tr, batch, z, draws, what, launches=None):
    """One fp32 D and G step at batch 2 through the kernels and with
    ``impl="ref"``: `_group_check` on each, and with ``launches`` the
    kernels' counts of the kernels' run. Returns False on a miss."""
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda

    placed, runs = tr._place(batch), {}
    z, draws = z.to(tr.device), _to(draws, tr.device)
    for impl in ("auto", "ref"):
        if launches is not None:
            flrelu_cuda.reset_launches()
        d = tr.d_loss_and_grads(placed, z, draws, 2.0, force_fp32=True, impl=impl)
        g = tr.g_loss_and_grads(placed, z, draws, 2.0, force_fp32=True, impl=impl)
        runs[impl] = {"D": (float(d[0]), d[2]), "G": (float(g[0]), g[2])}
        del d, g
        if impl == "auto" and launches is not None:
            counted = dict(flrelu_cuda.launches)
    ok = True
    if launches is not None:
        ok = counted == launches
        print(f"{what} launches {counted} (expected {launches})")
    for group in ("D", "G"):
        (la, ga), (lb, gb) = runs["auto"][group], runs["ref"][group]
        ok = _group_check(what, group, ga, gb, la, lb) and ok
    return ok


def setgan_training_phase(dev, card, bwd_kernel_call, bwd_plain_call) -> float:
    """Phase 16: SetGAN training at `train_setgan_stem.sh`'s recipe, 256²:
    (a) `SetGANTrainer.train_step` (SG3-T, IR-SE-50, DeiT-base + EfficientNet-
    lite0 as D, both remats, blur σ 2), one warm-up and timed steps (s per D
    step, G step and train_step, images/s, peak memory), the launches of #1
    and #2 a step, a traced step; (b) one D and one G step at batch 2 in fp32
    through the kernels against ``impl="ref"`` (losses, every gradient), the
    frozen projector byte for byte across the steps, #2 alone on SG3-T 256's
    layers at batch 64 in each layer's dtype (dx and db) timed beside its
    plain version and its bound; (c) the pretrained recipe's freezing (ReStyle-
    encoder mode, encoder and decoder frozen) for one step; (d) `generate`
    from G_ema. Returns #2's largest error against its plain version."""
    from stylegan3_editing_tpu_torch.models.sg3 import build_synthesis_layout, sg3_t_config
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda
    from stylegan3_editing_tpu_torch.setgan import (ImageMultiSetGenerator, SetGANLossConfig,
                                                    SetGANTrainConfig, SetGANTrainer)

    cfg_t = sg3_t_config(256, channel_base=16384, channel_max=256, num_layers=7)
    t_layers = [s for s in build_synthesis_layout(cfg_t).layers if s.up_filter is not None]
    n_layers = len(t_layers)

    def recipe(**kw):
        base = dict(batch_size=SETGAN_BATCH, d_latent_size=SETGAN_D_LATENT, g_attn_layers=2,
                    d_attn_layers=2, restyle_mode="none", restyle_iters=1, mean_center=False,
                    d_remat_features=True, g_remat_encoder=True,
                    ref_resolution=cfg_t.img_resolution,
                    loss=SetGANLossConfig(blur_init_sigma=2.0, blur_fade_kimg=300.0))
        return SetGANTrainConfig(**{**base, **kw})

    def seeded(tr, seed):
        """Non-trivial batch norms (IR-SE-50, EfficientNet-lite0), w_avg from
        256 mapped z, G_ema a copy of G."""
        seeded_batch_norms(tr.G.encoder, seed)
        seeded_batch_norms(tr.D, seed + 1)
        with torch.no_grad():
            z = torch.randn((256, cfg_t.z_dim), generator=torch.Generator().manual_seed(seed + 2))
            tr.G.decoder.mapping.w_avg.copy_(tr.G.decoder.map(z.to(dev))[:, 0].mean(0))
            tr.latent_avg = tr.G.decoder.mapping.w_avg.clone()
            tr.G_ema.load_state_dict(tr.G.state_dict())

    def launches_of(fn):
        flrelu_cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(flrelu_cuda.launches)

    t0 = time.perf_counter()
    tr = SetGANTrainer(recipe(), cfg_t, device=dev)
    seeded(tr, 190)
    with torch.no_grad():
        pool = tr.G.decoder(torch.randn((18, cfg_t.z_dim), generator=torch.Generator().manual_seed(
            193)).to(dev), truncation_psi=0.7).float().cpu().numpy()
    sampler = ImageMultiSetGenerator(RenderedClasses(pool, 3), SETGAN_BATCH,
                                     reference_range=SETGAN_REFS, candidate_range=SETGAN_CANDS,
                                     data_augmentation=True, seed=0)
    batches = [sampler.sample_batch() for _ in range(SETGAN_TIMED_STEPS + 3)]
    n_g = sum(p.numel() for p in tr.g_params.values())
    n_d = sum(p.numel() for p in tr.d_params.values())
    frozen = {n: p.detach().clone() for n, p in tr.D.named_parameters() if n.startswith("proj_")}
    print(f"setgan training: SG3-T 256 (7 layers), IR-SE-50, D {'+'.join(tr.D.backbones)} at "
          f"224^2 and 256^2, batch {SETGAN_BATCH}, references {SETGAN_REFS}, candidates "
          f"{SETGAN_CANDS}, d_latent {SETGAN_D_LATENT}, remat encoder and D trunks, blur sigma "
          f"2.0; {n_g} G and {n_d} D parameters train, {sum(t.numel() for t in frozen.values())} "
          f"projector parameters frozen; built in {time.perf_counter() - t0:.2f} s")

    # (a) A warm-up step, the launches of one step, then timed steps.
    tr.train_step(batches[0])
    torch.cuda.synchronize()
    _, launches = launches_of(lambda: tr.train_step(batches[1]))
    print(f"setgan train_step launches: {launches} ({n_layers} filtered layers: the D step's G "
          f"forward and the G step's, and the G step's backward)")
    if launches != {"filtered_lrelu_fwd": 2 * n_layers, "filtered_lrelu_bwd": n_layers,
                    **NO_FIR}:
        raise SystemExit("expected 14 forward and 7 backward launches a SetGAN train_step")
    events = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.setdefault(name, []).append(e)

    d_grads_fn, g_grads_fn, adam_fn = tr.d_loss_and_grads, tr.g_loss_and_grads, tr._adam_step

    def d_timed(*a, **k):
        mark("d0")
        return d_grads_fn(*a, **k)

    def g_timed(*a, **k):
        mark("g0")
        return g_grads_fn(*a, **k)

    def adam_timed(opt, params, grads, lr):
        adam_fn(opt, params, grads, lr)
        mark("d1" if opt is tr.d_opt else "g1")

    tr.d_loss_and_grads, tr.g_loss_and_grads, tr._adam_step = d_timed, g_timed, adam_timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_valid = 0
    for b in batches[2:2 + SETGAN_TIMED_STEPS]:
        mark("s0")
        metrics = tr.train_step(b)
        mark("s1")
        n_valid += int(b["cand_mask"].sum())
    torch.cuda.synchronize()
    del tr.d_loss_and_grads, tr.g_loss_and_grads, tr._adam_step
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def secs(a, b):
        return sum(x.elapsed_time(y) for x, y in zip(events[a], events[b])) / 1e3 / \
            SETGAN_TIMED_STEPS

    step_s, d_s, g_s = secs("s0", "s1"), secs("d0", "d1"), secs("g0", "g1")
    values = {k: float(v) for k, v in metrics.items()}
    print(f"setgan train_step time: {step_s:.4f} s a step (D step {d_s:.4f} s, G step "
          f"{g_s:.4f} s, G_ema and the rest {step_s - d_s - g_s:.4f} s) over "
          f"{SETGAN_TIMED_STEPS} steps, {n_valid / (step_s * SETGAN_TIMED_STEPS):.4f} trained "
          f"candidate images/s ({n_valid} valid of {SETGAN_TIMED_STEPS * SETGAN_BATCH * SETGAN_CANDS[1]} "
          f"slots), peak memory {peak:.3f} GiB {card}")
    print(f"setgan last timed step's metrics: {json.dumps(values)}")
    if not all(math.isfinite(v) for v in values.values()) or peak >= 80:
        raise SystemExit("SetGAN training: a non-finite metric, or over 80 GB")
    t = device_trace(lambda: tr.train_step(batches[-1]), ranges=[
        ("Dmain", None, None), ("Gmain", None, None), ("backward", None, None),
        ("adam", None, None), ("ema", None, None),
        ("encoder", tr.G.encoder, "forward"), ("style_attn", tr.G.style_attn, "forward"),
        ("decoder", tr.G.decoder, "synthesize"),
        *[(f"{bb} trunk", getattr(tr.D, f"proj_{bb}").backbone, "forward")
          for bb in tr.D.backbones],
        *[(f"{bb} heads", getattr(tr.D, f"d_{bb}"), "forward") for bb in tr.D.backbones]])
    print_trace("setgan train_step", t, card)
    moved = [n for n, p in frozen.items()
             if not torch.equal(_bits(p), _bits(dict(tr.D.named_parameters())[n]))]
    print(f"setgan frozen projector after {SETGAN_TIMED_STEPS + 3} steps: {len(frozen)} tensors, "
          f"{len(moved)} changed")
    if moved:
        raise SystemExit(f"the frozen projector moved: {moved[:3]}")

    # (b) Kernels against impl="ref": one D and one G step at batch 2 in fp32.
    b2 = {k: v[:2] for k, v in batches[0].items()}
    z2 = torch.randn((2, SETGAN_CANDS[1], cfg_t.z_dim),
                     generator=torch.Generator().manual_seed(194))
    if not _steps_vs(tr, b2, z2, tr.draw(2, SETGAN_CANDS[1]), "setgan, kernels vs impl='ref',"):
        raise SystemExit("SetGAN's steps through the kernels disagree with impl='ref'")
    torch.cuda.empty_cache()

    # #2 alone on SG3-T 256's layers at batch 64 (B·C), in each layer's dtype.
    *_, bwd_err = _bwd_rows(dev, card, t_layers, bwd_kernel_call, bwd_plain_call,
                            SETGAN_BATCH * SETGAN_CANDS[1], 1600, "SG3-T 256")

    # (d) Inference after training: G_ema's candidates.
    fakes = tr.generate(batches[0]["reference"][:2], SETGAN_CANDS[1])
    print(f"setgan generate from G_ema: {fakes.shape}, finite {bool(np.isfinite(fakes).all())}")
    res = cfg_t.img_resolution
    if fakes.shape != (2, SETGAN_CANDS[1], res, res, 3) or not np.isfinite(fakes).all():
        raise SystemExit("SetGAN generate: wrong or non-finite candidates")
    del tr, fakes
    torch.cuda.empty_cache()

    # (c) The pretrained recipe: ReStyle-encoder mode, encoder and decoder frozen.
    tr = SetGANTrainer(recipe(restyle_mode="encoder", restyle_iters=1, mean_center=None,
                              freeze_encoder=True, freeze_decoder=True, d_remat_features=False,
                              g_remat_encoder=False), cfg_t, device=dev)
    seeded(tr, 195)
    before = {n: p.detach().clone() for n, p in tr.G.named_parameters()}
    _, launches = launches_of(lambda: tr.train_step(batches[0]))
    same = {n: torch.equal(_bits(p), _bits(before[n])) for n, p in tr.G.named_parameters()}
    bad = [n for n, s in same.items() if s != (n.split(".")[0] in ("encoder", "decoder"))
           and not n.startswith(("style_attn.attn_0.", "style_attn.style_concat_0."))]
    attn_moved = sum(not s for n, s in same.items() if n.startswith("style_attn"))
    print(f"setgan pretrained recipe (restyle_mode encoder, 1 iteration, encoder and decoder "
          f"frozen), one step: launches {launches}; encoder and decoder byte for byte "
          f"{all(same[n] for n in same if n.split('.')[0] in ('encoder', 'decoder'))}, "
          f"{attn_moved} style-attention tensors moved; no decoder gradient (dx only) "
          f"{all(p.grad is None and not p.requires_grad for p in tr.G.decoder.parameters())}")
    if bad or not attn_moved or launches != {"filtered_lrelu_fwd": 4 * n_layers,
                                             "filtered_lrelu_bwd": n_layers, **NO_FIR}:
        raise SystemExit(f"the pretrained recipe's freezing failed: {bad[:3]}, launches "
                         f"{launches}")
    del tr, before
    torch.cuda.empty_cache()
    return bwd_err


FID_CLASSES, FID_ITEMS = 8, 16   # train_setgan's defaults: 8 classes, min(256, 16) items a class
FID_SELF_TOL = 1e-6        # a real set against itself reads at most this of its 2·tr(cov)
FID_SELF_FLOOR = -1e-5     # ... and not below this: sqrtm's rounding on a rank-15 product
FID_CARD_TOL = 1e-3        # the FID from the card's features vs the CPU's, relative (PERF.md)
SPECTRUM_TOL = 1e-5        # spectrum_stats card vs CPU, of max |ref|: fp32 FFTs (cuFFT, pocketfft)
NEW_FAMILIES = ("densenet121", "mobilenet_v2", "mnasnet1_0", "shufflenet_v2_x0_5", "regnetx_032",
                "regnety_032", "clip_vit_b32", "resnet50_clip")
D_NEW_FAMILIES = ("clip_vit_b32", "regnety_032")  # (d)'s discriminator: a ViT and an SE RegNet


def setgan_fid_phase(dev, card) -> None:
    """Phase 17: SetGAN's conditional FID in training and the registry's
    last families. (a) `train_setgan`'s trainer at `train_setgan_stem.sh`'s
    recipe (`build_trainer`) trained by `SetGANTrainer.train` for 2 ticks of
    one step with `make_fid_eval_fn` at the CLI's defaults (8 classes, 16
    items a class, InceptionV3 at 299^2 with its seeded init) every tick:
    s per evaluation, InceptionV3 ms per image at batch 16, `generate` ms
    per class, the FID in its three modes from the evaluation's features,
    peak memory, #1's launches per evaluation; (b) gates: InceptionV3 card vs
    CPU, the FID from the card's features vs the CPU's, a real set against
    itself, 14 + 7 launches a training step, `spectrum_stats` of the fakes
    card vs CPU; (c) each new family's four stages card vs CPU at the
    discriminator's input, batch 8, ms per image; (d) one fp32 D and G step
    at batch 2 with D on two new families through the kernels against
    ``impl="ref"``."""
    import copy
    import dataclasses
    import tempfile

    from stylegan3_editing_tpu_torch.models.backbones.inception import inception_feature_fn
    from stylegan3_editing_tpu_torch.models.backbones.registry import make_feature_network
    from stylegan3_editing_tpu_torch.models.sg3 import build_synthesis_layout
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda
    from stylegan3_editing_tpu_torch.scripts import train_setgan
    from stylegan3_editing_tpu_torch.setgan import (ConditionalFID, FeatureStats,
                                                    ImageMultiSetGenerator, frechet_distance)
    from stylegan3_editing_tpu_torch.utils.spectrum import spectrum_stats

    t0 = time.perf_counter()
    opts = train_setgan.SetGANCliOptions(
        outdir=tempfile.mkdtemp(), resolution=256, batch=SETGAN_BATCH, cbase=16384, cmax=256,
        syn_layers=7, reference_min=SETGAN_REFS[0], reference_max=SETGAN_REFS[1],
        candidate_min=SETGAN_CANDS[0], candidate_max=SETGAN_CANDS[1], d_latent=SETGAN_D_LATENT,
        g_attn_layers=2, d_attn_layers=2, restyle_mode="none", restyle_iters=1,
        no_mean_center=True, data_augmentation=True, d_remat_features=True,
        g_remat_encoder=True, encoder_res=256, tick_kimg=SETGAN_BATCH / 1000,
        total_kimg=2 * SETGAN_BATCH / 1000, eval_ticks=1, fid=True)

    def built(o, seed):
        """The CLI's trainer, no run directory (no Pillow here for the
        grids); non-trivial batch norms, w_avg from 256 mapped z, G_ema = G."""
        tr = train_setgan.build_trainer(o)
        tr.run_dir = None
        seeded_batch_norms(tr.G.encoder, seed)
        seeded_batch_norms(tr.D, seed + 1)
        with torch.no_grad():
            z = torch.randn((256, tr.decoder_cfg.z_dim),
                            generator=torch.Generator().manual_seed(seed + 2))
            tr.G.decoder.mapping.w_avg.copy_(tr.G.decoder.map(z.to(dev))[:, 0].mean(0))
            tr.latent_avg = tr.G.decoder.mapping.w_avg.clone()
            tr.G_ema.load_state_dict(tr.G.state_dict())
        return tr

    tr = built(opts, 1700)
    n_layers = sum(s.up_filter is not None for s in build_synthesis_layout(tr.decoder_cfg).layers)
    with torch.no_grad():
        pool = np.concatenate([tr.G.decoder(torch.randn(
            (FID_ITEMS, tr.decoder_cfg.z_dim), generator=torch.Generator().manual_seed(1703 + c)
        ).to(dev), truncation_psi=0.7).float().cpu().numpy() for c in range(FID_CLASSES)])
    classes = RenderedClasses(pool, FID_CLASSES)
    sampler = ImageMultiSetGenerator(classes, SETGAN_BATCH, reference_range=SETGAN_REFS,
                                     candidate_range=SETGAN_CANDS, data_augmentation=True, seed=0)
    made = []

    class Recording(ConditionalFID):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    evals = []
    train_setgan.ConditionalFID = Recording
    try:
        eval_fn = train_setgan.make_fid_eval_fn(opts, classes)

        def timed_eval(trainer):
            torch.cuda.synchronize()
            before, t = dict(flrelu_cuda.launches), time.perf_counter()
            value = eval_fn(trainer)
            torch.cuda.synchronize()
            evals.append((time.perf_counter() - t, {k: v - before[k] for k, v in
                                                    flrelu_cuda.launches.items()}, value))
            return value

        print(f"setgan fid: trainer and {len(pool)} renders in {FID_CLASSES} classes built in "
              f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flrelu_cuda.reset_launches()
        t = time.perf_counter()
        tr.train(iter(sampler), eval_fn=timed_eval)
        torch.cuda.synchronize()
        run_s, launches = time.perf_counter() - t, dict(flrelu_cuda.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        train_setgan.ConditionalFID = ConditionalFID
    (eval_s, eval_launches, agg), = evals
    steps = tr.d_steps
    step_launches = {k: (v - eval_launches[k]) / steps for k, v in launches.items()}
    print(f"setgan fid: train() at train_setgan_stem.sh's recipe, {steps} steps in 2 ticks with "
          f"the FID at the second: {run_s:.4f} s, peak memory {peak:.3f} GiB; launches "
          f"{launches} (the evaluation {eval_launches}, {step_launches} a step) {card}")
    print(f"setgan fid evaluation: {eval_s:.4f} s ({FID_CLASSES} classes x {FID_ITEMS} items: "
          f"{FID_CLASSES} generate calls, {2 * FID_CLASSES} InceptionV3 batches, one sqrtm), "
          f"#1 {eval_launches['filtered_lrelu_fwd']} launches "
          f"({eval_launches['filtered_lrelu_fwd'] / FID_CLASSES:g} a generate call) {card}")
    if (eval_launches != {"filtered_lrelu_fwd": n_layers * FID_CLASSES, "filtered_lrelu_bwd": 0,
                          **NO_FIR} or step_launches != {"filtered_lrelu_fwd": 2 * n_layers,
                                                         "filtered_lrelu_bwd": n_layers, **NO_FIR}
            or steps != 2 or tr.best_fid != agg):
        raise SystemExit("SetGAN FID: expected 7 launches a generate call, 14 + 7 a training "
                         "step, 2 steps and the evaluation's FID kept as the best")
    fid = made[0]
    feature_fn = fid.feature_fn
    t = time.perf_counter()
    sfid = fid.compute("sfid")
    sfid_s, t = time.perf_counter() - t, time.perf_counter()
    rfid = fid.compute("rfid")
    rfid_s = time.perf_counter() - t
    print(f"setgan fid, one set of features ({FID_CLASSES} classes x {FID_ITEMS} real and fake, "
          f"2048-d): agg {agg!r}, sfid {sfid!r} ({sfid_s:.2f} s, {FID_CLASSES} sqrtm), rfid "
          f"{rfid!r} ({rfid_s:.2f} s) {card}")
    if not all(math.isfinite(v) and v >= 0 for v in (agg, sfid, rfid)):
        raise SystemExit("SetGAN FID: a mode is not finite")

    real = classes.images[:FID_ITEMS]
    refs = real[None, :FID_ITEMS // 2]
    gen_ms = time_ms(lambda: tr.generate(refs, num_candidates=FID_ITEMS), 3, warmup=1)
    inc_ms = time_ms(lambda: feature_fn(real), 5)
    print(f"setgan fid timing: generate {gen_ms:.4f} ms a class ({FID_ITEMS // 2} references, "
          f"{FID_ITEMS} candidates), InceptionV3 {inc_ms / FID_ITEMS:.4f} ms an image at batch "
          f"{FID_ITEMS} (299^2, fp32) {card}")

    # (b) Gates: features, FID and spectrum card vs CPU; a set against itself.
    fakes = tr.generate(refs, num_candidates=FID_ITEMS)[0]
    cpu_fn = inception_feature_fn(device="cpu")
    card_real, card_fake = feature_fn(real), feature_fn(fakes)
    cpu_real, cpu_fake = cpu_fn(real), cpu_fn(fakes)
    err = max(float(np.abs(a - b).max()) for a, b in ((card_real, cpu_real),
                                                       (card_fake, cpu_fake)))
    scale = max(float(np.abs(cpu_real).max()), float(np.abs(cpu_fake).max()))

    def fid_of(a, b):
        s1, s2 = FeatureStats(), FeatureStats()
        s1.append(a)
        s2.append(b)
        return frechet_distance(*s1.get_mean_cov(), *s2.get_mean_cov())

    fid_card, fid_cpu = fid_of(card_real, card_fake), fid_of(cpu_real, cpu_fake)
    st = FeatureStats()
    st.append(card_real)
    mu, cov = st.get_mean_cov()
    self_fid, two_tr = frechet_distance(mu, cov, mu, cov), 2 * float(np.trace(cov))
    spec_card = spectrum_stats(torch.from_numpy(fakes).to(dev))
    spec_cpu = spectrum_stats(torch.from_numpy(fakes))
    spec_err = {k: float((spec_card[k].cpu() - spec_cpu[k]).abs().max()) /
                float(spec_cpu[k].abs().max()) for k in spec_cpu}
    print(f"setgan fid gates: InceptionV3 card vs CPU on {FID_ITEMS} + {FID_ITEMS} images max abs "
          f"err {err:.3e} (tol {EVAL_TOL:g} of max |ref| {scale:.4g}); FID card {fid_card!r} vs "
          f"CPU {fid_cpu!r} (relative {abs(fid_card - fid_cpu) / max(fid_cpu, 1e-30):.3e}, tol "
          f"{FID_CARD_TOL:g}); a real set against itself {self_fid!r}, {self_fid / two_tr:.3e} of "
          f"2 tr(cov) {two_tr:.6g} (at most {FID_SELF_TOL:g}, at least {FID_SELF_FLOOR:g}); "
          f"spectrum_stats of {FID_ITEMS} fakes card vs CPU, of max "
          f"|ref|: {json.dumps(spec_err)} (tol {SPECTRUM_TOL:g}) {card}")
    if (err > EVAL_TOL * scale or abs(fid_card - fid_cpu) > FID_CARD_TOL * fid_cpu
            or not FID_SELF_FLOOR * two_tr <= self_fid <= FID_SELF_TOL * two_tr
            or max(spec_err.values()) > SPECTRUM_TOL):
        raise SystemExit("SetGAN FID: a card-vs-CPU gate failed")
    del tr, fid, made, cpu_fn
    torch.cuda.empty_cache()

    # (c) Each new family's four stages, card vs CPU, batch 8.
    for i, name in enumerate(NEW_FAMILIES):
        net, spec = make_feature_network(name, generator=torch.Generator().manual_seed(1710 + i))
        seeded_batch_norms(net, 1720 + i)
        net.eval()
        side = spec.fixed_input_res or 256
        x = torch.tanh(torch.randn((8, side, side, 3), generator=torch.Generator().manual_seed(
            1730 + i)))
        x = (x * 0.5 + 0.5 - torch.from_numpy(spec.mean)) / torch.from_numpy(spec.std)
        on_card = copy.deepcopy(net).to(dev)
        with torch.no_grad():
            got = [f.cpu() for f in on_card(x.to(dev))]
            want = net(x)
            ms = time_ms(lambda: on_card(x.to(dev)), 3)
        errs = [float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want)]
        print(f"family {name} at {side}^2, batch 8: stages {[tuple(w.shape[1:]) for w in want]}, "
              f"card vs CPU of max |ref| {['%.2e' % e for e in errs]} (tol {EVAL_TOL:g}); "
              f"{ms / 8:.4f} ms an image {card}")
        if len(got) != 4 or max(errs) > EVAL_TOL or \
                [w.shape[-1] for w in want] != list(spec.channels):
            raise SystemExit(f"the {name} stages disagree between the card and the CPU")
        del net, on_card
    torch.cuda.empty_cache()

    # (d) One fp32 D and G step at batch 2, D on two new families, kernels vs impl="ref".
    tr = built(dataclasses.replace(opts, backbones=",".join(D_NEW_FAMILIES)), 1740)
    b2 = {k: v[:2] for k, v in sampler.sample_batch().items()}
    z2 = torch.randn((2, SETGAN_CANDS[1], tr.decoder_cfg.z_dim),
                     generator=torch.Generator().manual_seed(1744))
    ok = _steps_vs(tr, b2, z2, tr.draw(2, SETGAN_CANDS[1]),
                   f"setgan with D = {'+'.join(D_NEW_FAMILIES)}, kernels vs impl='ref',",
                   launches={"filtered_lrelu_fwd": 2 * n_layers, "filtered_lrelu_bwd": n_layers,
                             **NO_FIR})
    del tr
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("SetGAN's steps with the new families disagree with impl='ref'")



SUPERRES = dict(stem_res=256, res=512, cbase=16384, cmax=256, syn_layers=7, up_factor=2,
                head_layers=4)  # train_setgan_superres.sh (RES 512) on train_setgan_stem.sh's stem
SUPERRES_REFS, SUPERRES_CANDS = (1, 2), (1, 2)
SUPERRES_CARRIED = 17      # the leaves reinit_stem carries at the recipe's widths
SUPERRES_STEPS = 3         # timed train() steps after one warm-up step
PRETRAINED_STEPS = 2
STEM_STEPS = 1             # timed train_steps of each other stem after one warm-up
SG2_FFHQ = dict(size=1024, style_dim=512, n_mlp=8, channel_multiplier=2)  # rosinality FFHQ
SG2_BATCH = 4
# G's gradients card vs CPU through one cotangent of the images: the two devices'
# forwards differ by ~1e-5, which flips the lrelu's slope (1 or 0.2) and the clamp
# on pre-activations near their kinks, so a gradient summed over every pixel (a
# noise strength) moves by up to 1.2e-3 of the group's largest entry (PERF.md
# section 6; GRAD_TOL's 1e-3 holds only within one device).
STEM_GRAD_TOL = 5e-3


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat_tree(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def _trees_equal(got, want) -> list:
    """The leaves of ``want`` that ``got`` lacks or holds other bytes of."""
    got, want = _flat_tree(got), _flat_tree(want)
    return [k for k, v in want.items()
            if k not in got or got[k].shape != v.shape or got[k].tobytes() != v.tobytes()]


def sg2_reference_state(G) -> dict:
    """The ``"sg2"`` stem's state in the reference's `networks_stylegan2`
    naming (what `convert_sg2_state` reads): ``synthesis.`` before each
    block, the const CHW, conv weights OIHW."""
    state = {}
    for k, v in G.state_dict().items():
        v = v.detach().cpu().clone()
        if k.startswith("mapping."):
            state[k] = v
        elif k.endswith(".const"):
            state[f"synthesis.{k}"] = v.permute(2, 0, 1).contiguous()
        elif k.endswith(".weight") and v.ndim == 4:
            state[f"synthesis.{k}"] = v.permute(3, 2, 0, 1).contiguous()
        else:
            state[f"synthesis.{k}"] = v
    return state


_MBV2_T1 = {"conv_dw": "0.0", "bn2": "0.1", "conv_pwl": "1", "bn3": "2"}
_MBV2 = {"conv_pw": "0.0", "bn1": "0.1", "conv_dw": "1.0", "bn2": "1.1", "conv_pwl": "2",
         "bn3": "3"}
_TORCH_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def mobilenet_v2_reference_state(net) -> dict:
    """The registry's MobileNetV2 in torchvision's naming (``features.N…``)."""
    state = {}
    for key, v in net.state_dict().items():
        path, _, leaf = key.rpartition(".")
        if path in ("conv_stem", "bn_stem"):
            module = {"conv_stem": "features.0.0", "bn_stem": "features.0.1"}[path]
        else:
            block, layer = path.split(".")
            i = int(block[len("block"):])
            module = f"features.{i}.conv.{(_MBV2_T1 if i == 1 else _MBV2)[layer]}"
        v = v.detach().cpu()
        state[f"{module}.{'weight' if leaf == 'kernel' else _TORCH_BN[leaf]}"] = (
            v.permute(3, 2, 0, 1).contiguous() if leaf == "kernel" else v.clone())
    return state


def _card_vs_cpu_steps(card, cpu, batch, z, draws, what):
    """G's fp32 forward at batch 2 of two trainers with the same weights, on
    the card and on the CPU: the images within `IMAGE_TOL` of max |ref|; the
    G step's losses within `MAPPER_LOSS_TOL`, and its gradients through G
    from one cotangent of the images (the CPU's dL/dimages) within
    `STEM_GRAD_TOL`. D is the projected discriminator that phases 16 and 17
    hold; here it only gives the cotangent. Returns False on a miss."""
    from stylegan3_editing_tpu_torch.setgan.loss import blur_images, g_main_loss

    sides = {}
    for key, tr in (("card", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        placed = tr._place(batch)
        zz, dd = z.to(tr.device), _to(draws, tr.device)
        imgs, _ = tr._run_g(tr.G, placed, zz, True)
        with torch.set_grad_enabled(key == "cpu"):
            logits = tr.D(placed["reference"], blur_images(imgs if key == "cpu" else
                                                           imgs.detach(), 2.0),
                          draws=dd["g"], r_mask=placed["ref_mask"], x_mask=placed["cand_mask"],
                          ada_p=tr._ada_p())
            g_loss = g_main_loss(logits)
        sides[key] = dict(imgs=imgs, g_loss=g_loss, params=list(tr.g_params.values()))
        print(f"{what} the {key} side's G forward: {time.perf_counter() - t0:.2f} s")
    c, p = sides["cpu"], sides["card"]
    grads = torch.autograd.grad(c["g_loss"], [c["imgs"]] + c["params"], allow_unused=True)
    want = {n: torch.zeros_like(t) if g is None else g
            for n, t, g in zip(cpu.g_params, c["params"], grads[1:])}
    card_grads = torch.autograd.grad(p["imgs"], p["params"],
                                     grad_outputs=grads[0].to(card.device), allow_unused=True)
    got = {n: torch.zeros_like(t).cpu() if g is None else g.cpu()
           for n, t, g in zip(card.g_params, p["params"], card_grads)}
    fake = c["imgs"].detach()
    img_err = float((p["imgs"].detach().cpu() - fake).abs().max())
    img_max = float(fake.abs().max())
    print(f"{what} G's images, batch 2 fp32: max abs err {img_err:.3e} (tol {IMAGE_TOL:g} of "
          f"max |ref| {img_max:.4g})")
    ok = img_err <= IMAGE_TOL * img_max
    ok = _group_check(f"{what} (through G from the CPU's dL/dimages)", "G", got, want,
                      float(p["g_loss"]), float(c["g_loss"].detach()),
                      tol=STEM_GRAD_TOL) and ok
    return ok


def _timed_steps(tr, run, n_steps):
    """Run ``run()`` (steps of ``tr``) with CUDA events around each D step, G
    step and step; the means over the last ``n_steps`` steps (s)."""
    events = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.setdefault(name, []).append(e)

    d_fn, g_fn, adam_fn, step_fn = (tr.d_loss_and_grads, tr.g_loss_and_grads, tr._adam_step,
                                    tr.train_step)

    def d_timed(*a, **k):
        mark("d0")
        return d_fn(*a, **k)

    def g_timed(*a, **k):
        mark("g0")
        return g_fn(*a, **k)

    def adam_timed(opt, params, grads, lr):
        adam_fn(opt, params, grads, lr)
        mark("d1" if opt is tr.d_opt else "g1")

    def step_timed(*a, **k):
        mark("s0")
        out = step_fn(*a, **k)
        mark("s1")
        return out

    tr.d_loss_and_grads, tr.g_loss_and_grads, tr._adam_step, tr.train_step = (
        d_timed, g_timed, adam_timed, step_timed)
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        del tr.d_loss_and_grads, tr.g_loss_and_grads, tr._adam_step, tr.train_step

    def secs(a, b):
        pairs = list(zip(events[a], events[b]))[-n_steps:]
        return sum(x.elapsed_time(y) for x, y in pairs) / 1e3 / len(pairs)

    return out, secs("s0", "s1"), secs("d0", "d1"), secs("g0", "g1")


def superres_stems_phase(dev, card, layer_call, kernel_call, bwd_kernel_call, bwd_plain_call):
    """Phase 18: SetGAN's progressive growth, its pretrained recipe with real
    files, the other stems, the rosinality StyleGAN2 and the last
    `convert_checkpoint` kinds. Returns (#1's and #2's largest errors
    against their plain versions, #1's and #2's launches on this path, the
    per-layer rows of both kernels on the grown decoder)."""
    import functools
    import pickle
    import shutil
    import tempfile

    from stylegan3_editing_tpu_torch.models.backbones.registry import make_feature_network
    from stylegan3_editing_tpu_torch.models.encoders import convert_restyle_encoder_state
    from stylegan3_editing_tpu_torch.models.sg3 import (Generator, build_synthesis_layout,
                                                        sg3_t_config, to_jax_variables)
    from stylegan3_editing_tpu_torch.models.sg3.convert import load_torch_pt, npz_to_variables
    from stylegan3_editing_tpu_torch.models.stylegan2 import SG2Discriminator, SG2Generator
    from stylegan3_editing_tpu_torch.ops import flrelu_cuda
    from stylegan3_editing_tpu_torch.runtime.checkpoint import load_pytree
    from stylegan3_editing_tpu_torch.scripts import convert_checkpoint, train_setgan
    from stylegan3_editing_tpu_torch.setgan import (ImageMultiSetGenerator, SetGANLossConfig,
                                                    SetGANTrainConfig, SetGANTrainer)

    R = SUPERRES
    tmp = Path(tempfile.mkdtemp())
    launches_out, rows = {}, {}
    clock = [time.perf_counter()]

    def _elapsed(what):
        now = time.perf_counter()
        print(f"elapsed in phase 18: {what} {now - clock[0]:.1f} s")
        clock[0] = now

    def seeded(tr, seed, w_avg=True):
        """Non-trivial batch norms (the encoder's and D's), with ``w_avg``
        the decoder's from 256 mapped z; G_ema a copy of G."""
        seeded_batch_norms(tr.G.encoder, seed)
        seeded_batch_norms(tr.D, seed + 1)
        with torch.no_grad():
            if w_avg:
                z = torch.randn((256, tr.decoder_cfg.z_dim),
                                generator=torch.Generator().manual_seed(seed + 2))
                tr.G.decoder.mapping.w_avg.copy_(tr.G.decoder.map(z.to(dev))[:, 0].mean(0))
                tr.latent_avg = tr.G.decoder.mapping.w_avg.clone()
            tr.G_ema.load_state_dict(tr.G.state_dict())

    def renders(decoder, n, seed):
        with torch.no_grad():
            z = torch.randn((n, decoder.mapping.z_dim if hasattr(decoder, "mapping") else
                             decoder.cfg.z_dim), generator=torch.Generator().manual_seed(seed))
            return torch.cat([decoder(z[i:i + 6].to(dev)).float().cpu()
                              for i in range(0, n, 6)]).numpy()

    common = dict(batch=SETGAN_BATCH, cbase=R["cbase"], cmax=R["cmax"], syn_layers=R["syn_layers"],
                  d_latent=SETGAN_D_LATENT, g_attn_layers=2, d_attn_layers=2, restyle_iters=1,
                  data_augmentation=True, fid=False, snapshot_ticks=10 ** 6)
    try:
        # (a) The stem: one train() step at train_setgan_stem.sh's recipe, snapshotted.
        t0 = time.perf_counter()
        stem = train_setgan.build_trainer(train_setgan.SetGANCliOptions(
            outdir=str(tmp / "stem"), resolution=R["stem_res"], reference_min=SETGAN_REFS[0],
            reference_max=SETGAN_REFS[1], candidate_min=SETGAN_CANDS[0],
            candidate_max=SETGAN_CANDS[1], restyle_mode="none", no_mean_center=True,
            d_remat_features=True, g_remat_encoder=True, encoder_res=R["stem_res"],
            tick_kimg=SETGAN_BATCH / 1000, total_kimg=SETGAN_BATCH / 1000, **common))
        stem.run_dir = None
        seeded(stem, 1800)
        pool = renders(stem.G.decoder, 18, 1803)
        stem.train(iter(ImageMultiSetGenerator(RenderedClasses(pool, 3), SETGAN_BATCH,
                                               reference_range=SETGAN_REFS,
                                               candidate_range=SETGAN_CANDS,
                                               data_augmentation=True, seed=0)))
        t1 = time.perf_counter()
        stem.snapshot(tmp / "stem_snapshot")
        snap_s = time.perf_counter() - t1
        snap_gb = sum(f.stat().st_size for f in (tmp / "stem_snapshot").rglob("*")) / 2 ** 30
        print(f"superres stem: train_setgan_stem.sh's recipe at {R['stem_res']}^2, "
              f"{stem.d_steps} step through train(), snapshot {snap_gb:.3f} GiB written in "
              f"{snap_s:.2f} s; {time.perf_counter() - t0:.2f} s in all")
        del stem, pool
        torch.cuda.empty_cache()

        _elapsed("stem snapshot")
        # (a) The superres run: train_setgan's build_trainer and train at the recipe.
        t0 = time.perf_counter()
        sr_opts = train_setgan.SetGANCliOptions(
            outdir=str(tmp / "superres"), resolution=R["res"], superres=True,
            up_factor=R["up_factor"], head_layers=R["head_layers"],
            path_stem=str(tmp / "stem_snapshot"), reference_min=SUPERRES_REFS[0],
            reference_max=SUPERRES_REFS[1], candidate_min=SUPERRES_CANDS[0],
            candidate_max=SUPERRES_CANDS[1], restyle_mode="none", encoder_res=R["stem_res"],
            tick_kimg=(SUPERRES_STEPS + 1) * SETGAN_BATCH / 1000,
            total_kimg=(SUPERRES_STEPS + 1) * SETGAN_BATCH / 1000, **common)
        tr = train_setgan.build_trainer(sr_opts)
        tr.run_dir = None
        seeded(tr, 1810, w_avg=False)  # w_avg is the stem's, carried
        build_s = time.perf_counter() - t0
        layers = [s for s in build_synthesis_layout(tr.decoder_cfg).layers
                  if s.up_filter is not None]
        n_layers, heads = len(layers), tr.cfg.head_layer_names
        stem_tree, _ = load_pytree(tmp / "stem_snapshot")
        stem_dec = {c: stem_tree["g_vars"][c]["decoder"] for c in ("params", "buffers", "ema")}
        del stem_tree

        def carried_moved():
            now = to_jax_variables(tr.G.decoder)
            return [p for p in tr.carried["decoder"]
                    if _leaf(now, p).tobytes() != _leaf(stem_dec, p).tobytes()]

        carried = tr.carried["decoder"]
        frozen = {n: p.detach().clone() for n, p in tr.G.named_parameters()
                  if n not in tr.g_params}
        frozen.update({f"D.{n}": p.detach().clone() for n, p in tr.D.named_parameters()
                       if n not in tr.d_params})
        print(f"superres: {R['stem_res']}^2 stem grown to {R['res']}^2 (x{R['up_factor']}, "
              f"{R['head_layers']} head layers): {n_layers} filtered layers "
              f"{[s.name for s in layers]}, heads {list(heads)}; reinit_stem carried "
              f"{len(carried)} leaves; {sum(p.numel() for p in tr.g_params.values())} G "
              f"parameters train, {len(frozen)} tensors frozen; D {'+'.join(tr.D.backbones)}; "
              f"built in {build_s:.2f} s")
        moved = carried_moved()
        if len(carried) != SUPERRES_CARRIED or moved:
            raise SystemExit(f"superres: reinit_stem carried {len(carried)} leaves "
                             f"({SUPERRES_CARRIED} at the recipe), {moved[:3]} not the snapshot's")
        pool = renders(tr.G.decoder, 18, 1813)
        sampler = ImageMultiSetGenerator(RenderedClasses(pool, 3), SETGAN_BATCH,
                                         reference_range=SUPERRES_REFS,
                                         candidate_range=SUPERRES_CANDS, data_augmentation=True,
                                         seed=0)
        batches = [sampler.sample_batch() for _ in range(SUPERRES_STEPS + 2)]
        flrelu_cuda.reset_launches()
        with torch.no_grad():
            tr.generate(batches[0]["reference"][:2], 2)
        torch.cuda.synchronize()
        g_fwd = flrelu_cuda.launches["filtered_lrelu_fwd"]
        torch.cuda.reset_peak_memory_stats()
        flrelu_cuda.reset_launches()
        n_valid = sum(int(b["cand_mask"].sum()) for b in batches[1:SUPERRES_STEPS + 1])
        _, step_s, d_s, g_s = _timed_steps(
            tr, lambda: tr.train(iter(batches[:SUPERRES_STEPS + 1])), SUPERRES_STEPS)
        steps = tr.d_steps
        step_launches = {k: v / steps for k, v in flrelu_cuda.launches.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"superres G forward (generate): #1 {g_fwd} launches; train(): {steps} steps, "
              f"launches a step {step_launches}")
        print(f"superres train_step time: {step_s:.4f} s a step (D step {d_s:.4f} s, G step "
              f"{g_s:.4f} s, G_ema and the rest {step_s - d_s - g_s:.4f} s) over the last "
              f"{SUPERRES_STEPS} of {steps} steps, {n_valid / (step_s * SUPERRES_STEPS):.4f} "
              f"trained candidate images/s ({n_valid} valid of "
              f"{SUPERRES_STEPS * SETGAN_BATCH * SUPERRES_CANDS[1]} slots), peak memory "
              f"{peak:.3f} GiB at batch {SETGAN_BATCH} {card}")
        launches_out["superres G forward"] = g_fwd
        launches_out["superres train_step"] = step_launches
        # The G step's backward crosses every filtered layer: the style attention and
        # the encoder train, and each layer's affine takes a w from them.
        if g_fwd != n_layers or step_launches != {
                "filtered_lrelu_fwd": 2 * n_layers, "filtered_lrelu_bwd": n_layers, **NO_FIR}:
            raise SystemExit(f"superres: expected {n_layers} launches a G forward and "
                             f"{2 * n_layers} + {n_layers} a train_step")
        if peak >= 80:
            raise SystemExit(f"superres at batch {SETGAN_BATCH}: peak {peak:.3f} GiB, over 80 GB")
        t = device_trace(lambda: tr.train_step(batches[-1]), ranges=[
            ("Dmain", None, None), ("Gmain", None, None), ("backward", None, None),
            ("encoder", tr.G.encoder, "forward"), ("decoder", tr.G.decoder, "synthesize"),
            *[(f"{bb} trunk", getattr(tr.D, f"proj_{bb}").backbone, "forward")
              for bb in tr.D.backbones]])
        print_trace("superres train_step", t, card)
        moved = [n for n, p in frozen.items() if not torch.equal(_bits(p), _bits(
            (dict(tr.D.named_parameters())[n[2:]] if n.startswith("D.")
             else dict(tr.G.named_parameters())[n])))]
        moved_carried = carried_moved()
        print(f"superres after {tr.d_steps} steps: {len(frozen)} frozen tensors, {len(moved)} "
              f"changed; carried leaves still the snapshot's: {not moved_carried}")
        if moved or moved_carried:
            raise SystemExit(f"superres: frozen tensors moved: {(moved + moved_carried)[:3]}")

        # Kernels against impl="ref": one D and one G step at batch 2 in fp32.
        b2 = {k: v[:2] for k, v in batches[0].items()}
        z2 = torch.randn((2, SUPERRES_CANDS[1], tr.decoder_cfg.z_dim),
                         generator=torch.Generator().manual_seed(1814))
        if not _steps_vs(tr, b2, z2, tr.draw(2, SUPERRES_CANDS[1]),
                         "superres, kernels vs impl='ref',"):
            raise SystemExit("superres: the steps through the kernels disagree with impl='ref'")
        del tr, frozen, pool, sampler
        torch.cuda.empty_cache()

        _elapsed("superres steps and their gates")
        # #1 and #2 alone on each layer of the grown decoder at batch 32 (B·C).
        batch = SETGAN_BATCH * SUPERRES_CANDS[1]
        what = f"SetGAN superres {R['res']}"
        ms, bound, fwd_err, plain = layer_rows(dev, card, layers, layer_call, kernel_call, batch,
                                               False, 1820, what, plain_chunk=PLAIN_CHUNK)
        rows["fwd"] = dict(ms=ms, bound_ms=bound, plain_ms=plain, batch=batch)
        b_ms, b_bound, b_plain, bwd_err = _bwd_rows(dev, card, layers, bwd_kernel_call,
                                                    bwd_plain_call, batch, 1840, what)
        rows["bwd"] = dict(ms=b_ms, bound_ms=b_bound, plain_ms=b_plain, batch=batch)

        _elapsed("#1 and #2 on the grown layers")
        # (b) The pretrained recipe with reference-format files.
        t0 = time.perf_counter()
        cfg256 = sg3_t_config(R["stem_res"], channel_base=R["cbase"], channel_max=R["cmax"],
                              num_layers=R["syn_layers"])
        G = Generator(cfg256, device=dev, generator=torch.Generator().manual_seed(1850))
        with torch.no_grad():
            z = torch.randn((256, cfg256.z_dim), generator=torch.Generator().manual_seed(1851))
            G.mapping.w_avg.copy_(G.map(z.to(dev))[:, 0].mean(0))
        torch.save(reference_state(G), tmp / "sg3t256.pt")
        enc_state = irse_reference_state(cfg256.num_ws, 1852)
        torch.save({"state_dict": {f"encoder.{k}": v for k, v in enc_state.items()},
                    "opts": {"encoder_type": "ProgressiveBackboneEncoder"}},
                   tmp / "restyle_e4e.pt")
        pool = renders(G, 21, 1853)
        del G
        tr = train_setgan.build_trainer(train_setgan.SetGANCliOptions(
            outdir=str(tmp / "pretrained"), resolution=R["stem_res"],
            encoder_type="ProgressiveBackboneEncoder", reference_min=SETGAN_REFS[0],
            reference_max=SETGAN_REFS[1], candidate_min=SETGAN_CANDS[0],
            candidate_max=SETGAN_CANDS[1], restyle_mode="encoder", freeze_encoder=True,
            freeze_decoder=True, use_set_decoder=True, encoder_path=str(tmp / "restyle_e4e.pt"),
            generator_path=str(tmp / "sg3t256.pt"),
            tick_kimg=PRETRAINED_STEPS * SETGAN_BATCH / 1000,
            total_kimg=PRETRAINED_STEPS * SETGAN_BATCH / 1000, **common))
        tr.run_dir = None
        seeded_batch_norms(tr.D, 1854)
        load_s = time.perf_counter() - t0
        want_enc = convert_restyle_encoder_state(enc_state)[0]
        want_dec = load_torch_pt(tmp / "sg3t256.pt", cfg256)[0]

        def pretrained_misses():
            return (_trees_equal(to_jax_variables(tr.G.encoder), want_enc)
                    + _trees_equal(to_jax_variables(tr.G.decoder), want_dec))

        miss = pretrained_misses()
        print(f"pretrained recipe: --encoder_path (IR-SE-50 e4e, {cfg256.num_ws} styles, 6 input "
              f"channels, reference-format .pt) and --generator_path (SG3-T {R['stem_res']} "
              f".pt) loaded in {load_s:.2f} s; {len(tr.carried['encoder'])} encoder leaves "
              f"carried; the merged encoder and decoder equal the converted files: {not miss}")
        if miss:
            raise SystemExit(f"pretrained recipe: the merged weights differ from the files': "
                             f"{miss[:3]}")
        sampler = ImageMultiSetGenerator(RenderedClasses(pool, 3), SETGAN_BATCH,
                                         reference_range=SETGAN_REFS,
                                         candidate_range=SETGAN_CANDS, data_augmentation=True,
                                         seed=0)
        flrelu_cuda.reset_launches()
        _, step_s, d_s, g_s = _timed_steps(tr, lambda: tr.train(iter(sampler)), 1)
        launches_out["pretrained train_step"] = {
            k: v / tr.d_steps for k, v in flrelu_cuda.launches.items()}
        miss = pretrained_misses()
        print(f"pretrained recipe: {tr.d_steps} steps through train(), the last {step_s:.4f} s "
              f"(D step {d_s:.4f} s, G step {g_s:.4f} s); launches a step "
              f"{launches_out['pretrained train_step']}; encoder and decoder byte for byte after "
              f"the steps: {not miss} {card}")
        if miss or tr.d_steps != PRETRAINED_STEPS:
            raise SystemExit(f"pretrained recipe: the frozen encoder or decoder moved: {miss[:3]}")
        del tr, pool, sampler
        torch.cuda.empty_cache()

        _elapsed("the pretrained recipe")
        # (c) The sg2 and fastgan stems at train_setgan_stem.sh's recipe.
        cfg_t = sg3_t_config(R["stem_res"], channel_base=R["cbase"], channel_max=R["cmax"],
                             num_layers=R["syn_layers"])

        def recipe(**kw):
            base = dict(batch_size=SETGAN_BATCH, d_latent_size=SETGAN_D_LATENT, g_attn_layers=2,
                        d_attn_layers=2, restyle_mode="none", restyle_iters=1, mean_center=False,
                        d_remat_features=True, g_remat_encoder=True,
                        ref_resolution=R["stem_res"],
                        loss=SetGANLossConfig(blur_init_sigma=2.0, blur_fade_kimg=300.0))
            return SetGANTrainConfig(**{**base, **kw})

        for stem_name in ("sg2", "fastgan"):
            t0 = time.perf_counter()
            tr = SetGANTrainer(recipe(stem=stem_name), cfg_t, device=dev)
            seeded(tr, 1860, w_avg=False)
            pool = renders(tr.G.decoder, 18, 1861)
            sampler = ImageMultiSetGenerator(RenderedClasses(pool, 3), SETGAN_BATCH,
                                             reference_range=SETGAN_REFS,
                                             candidate_range=SETGAN_CANDS,
                                             data_augmentation=True, seed=0)
            batches = [sampler.sample_batch() for _ in range(STEM_STEPS + 2)]
            torch.cuda.reset_peak_memory_stats()
            flrelu_cuda.reset_launches()

            def run():
                for b in batches[:STEM_STEPS + 1]:
                    metrics = tr.train_step(b)
                return metrics

            metrics, step_s, d_s, g_s = _timed_steps(tr, run, STEM_STEPS)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            launches = dict(flrelu_cuda.launches)
            values = {k: float(v) for k, v in metrics.items()}
            n_dec = sum(p.numel() for p in tr.G.decoder.parameters())
            print(f"stem {stem_name}: train_setgan_stem.sh's recipe at {R['stem_res']}^2, "
                  f"decoder {n_dec} parameters, {tr.G.n_styles} W entries; {step_s:.4f} s a step "
                  f"(D {d_s:.4f} s, G {g_s:.4f} s) over {STEM_STEPS} steps after a warm-up, peak "
                  f"{peak:.3f} GiB; launches {launches}; built in "
                  f"{time.perf_counter() - t0:.2f} s {card}")
            if launches != {**FLRELU, **NO_FIR} or not all(
                    math.isfinite(v) for v in values.values()) or peak >= 80:
                raise SystemExit(f"stem {stem_name}: a hand kernel launched, a non-finite metric "
                                 f"or over 80 GB: {launches}, {values}")
            t = device_trace(lambda: tr.train_step(batches[-1]), ranges=[
                ("decoder", tr.G.decoder, "synthesize"), ("encoder", tr.G.encoder, "forward")])
            print_trace(f"stem {stem_name} train_step", t, card)
            # 2 sets of 2 references and 1 candidate, to keep the CPU's side short.
            b2 = {k: v[:2, :2] if k.startswith("ref") else
                  v[:2, :1] if k.startswith("cand") else v[:2] for k, v in batches[0].items()}
            b2["ref_mask"], b2["cand_mask"] = np.ones_like(b2["ref_mask"]), np.ones_like(
                b2["cand_mask"])
            del tr, pool, sampler, batches
            torch.cuda.empty_cache()
            # Card against CPU: the same seeded trainers, noise and draws; D on
            # EfficientNet-lite0 alone and the 8-layer IR-SE trunk, frozen, to keep
            # the CPU's side short (the stem is what this holds).
            small = recipe(stem=stem_name, d_backbones=("tf_efficientnet_lite0",),
                           encoder_num_layers=8, freeze_encoder=True, d_remat_features=False,
                           g_remat_encoder=False)
            pair = {}
            for device in (dev, "cpu"):
                pair[str(device)] = SetGANTrainer(small, cfg_t, device=device)
                seeded(pair[str(device)], 1870, w_avg=False)
            noise = pair["cpu"].G.decoder.draw_noise(
                2, torch.device("cpu"), torch.Generator().manual_seed(1871))
            for key, tr in pair.items():
                tr.G.decoder.synthesize = functools.partial(
                    tr.G.decoder.synthesize, noise=_to(noise, tr.device))
            z2 = torch.randn((2, 1, cfg_t.z_dim), generator=torch.Generator().manual_seed(1872))
            draws = _to(pair[str(dev)].draw(2, 1), torch.device("cpu"))
            t1 = time.perf_counter()
            ok = _card_vs_cpu_steps(pair[str(dev)], pair["cpu"], b2, z2, draws,
                                    f"stem {stem_name}, card vs CPU,")
            print(f"stem {stem_name}: card vs CPU steps in {time.perf_counter() - t1:.2f} s")
            del pair
            torch.cuda.empty_cache()
            if not ok:
                raise SystemExit(f"stem {stem_name}: the card's step disagrees with the CPU's")
            _elapsed(f"the {stem_name} stem")

        # (d) The rosinality StyleGAN2 zoo row at the FFHQ 1024 widths.
        t0 = time.perf_counter()
        nets = {}
        for device in (dev, "cpu"):
            nets[str(device)] = (
                SG2Generator(**SG2_FFHQ, device=device,
                             generator=torch.Generator().manual_seed(1880)),
                SG2Discriminator(SG2_FFHQ["size"], SG2_FFHQ["channel_multiplier"],
                                 device=device, generator=torch.Generator().manual_seed(1881)))
        g_cpu = nets["cpu"][0]
        with torch.no_grad():
            for n, p in list(nets["cpu"][0].named_parameters()) + list(
                    nets[str(dev)][0].named_parameters()):
                if n.endswith("noise.weight"):
                    p.fill_(0.1)
        gen = torch.Generator().manual_seed(1882)
        z = torch.randn((SG2_BATCH, SG2_FFHQ["style_dim"]), generator=gen)
        noise = [torch.randn((SG2_BATCH, r, r, 1), generator=gen)
                 for r in [4] + [2 ** (i // 2 + 3) for i in range(2 * (g_cpu.log_size - 2))]]
        with torch.no_grad():
            img_cpu = g_cpu(z, noise=noise)
            logits_cpu = nets["cpu"][1](img_cpu)
            g_dev, d_dev = nets[str(dev)]
            zd, nd, imgd = z.to(dev), [n.to(dev) for n in noise], img_cpu.to(dev)
            img_dev, logits_dev = g_dev(zd, noise=nd), d_dev(imgd)
            g_ms = time_ms(lambda: g_dev(zd, noise=nd), 3, warmup=1)
            d_ms = time_ms(lambda: d_dev(imgd), 3, warmup=1)
        errs = [float((a.cpu() - b).abs().max()) / float(b.abs().max())
                for a, b in ((img_dev, img_cpu), (logits_dev, logits_cpu))]
        print(f"rosinality SG2 at the FFHQ widths ({SG2_FFHQ}), batch {SG2_BATCH}, fixed noise: "
              f"generator card vs CPU {errs[0]:.3e} of max |ref|, discriminator {errs[1]:.3e} "
              f"(tol {EVAL_TOL:g}); {g_ms / SG2_BATCH:.4f} ms an image through G, "
              f"{d_ms / SG2_BATCH:.4f} ms through D; {time.perf_counter() - t0:.2f} s {card}")
        del nets, g_cpu, g_dev, d_dev, img_dev, imgd
        torch.cuda.empty_cache()
        if max(errs) > EVAL_TOL:
            raise SystemExit("the rosinality SG2 on the card disagrees with the CPU")

        _elapsed("the rosinality StyleGAN2")
        # (e) convert_checkpoint's last three kinds on reference-format files.
        from stylegan3_editing_tpu_torch.models.sg2_stem import SG2Config, SG2Generator as Stem

        stem = Stem(SG2Config(img_resolution=R["stem_res"], channel_base=R["cbase"],
                              channel_max=R["cmax"]), device="cpu",
                    generator=torch.Generator().manual_seed(1890))
        net, _ = make_feature_network("mobilenet_v2", generator=torch.Generator().manual_seed(1891))
        seeded_batch_norms(net, 1892)
        emb = torch.nn.Embedding(1000, 320)  # the shape of in_embeddings/tf_efficientnet_lite0.pkl
        torch.save(sg2_reference_state(stem), tmp / "sg2.pt")
        torch.save(mobilenet_v2_reference_state(net), tmp / "mobilenet_v2.pt")
        with open(tmp / "embed.pkl", "wb") as f:
            pickle.dump({"embed": emb}, f)
        for kind, src, kw, want in (
                ("sg2_stem", "sg2.pt", dict(res=R["stem_res"], cfg_overrides=dict(
                    channel_base=R["cbase"], channel_max=R["cmax"])), to_jax_variables(stem)),
                ("backbone", "mobilenet_v2.pt", dict(name="mobilenet_v2"), to_jax_variables(net)),
                ("class_embedding", "embed.pkl", {},
                 {"class_embedding": emb.weight.detach().numpy()})):
            t1 = time.perf_counter()
            convert_checkpoint.convert(str(tmp / src), str(tmp / kind), kind=kind, **kw)
            got = npz_to_variables(tmp / f"{kind}.npz")
            miss = _trees_equal(got, want) + _trees_equal(want, got)
            print(f"convert_checkpoint --kind {kind}: {len(_flat_tree(want))} leaves, equal to the "
                  f"source: {not miss}; {time.perf_counter() - t1:.2f} s")
            if miss:
                raise SystemExit(f"convert_checkpoint --kind {kind}: {miss[:3]} differ")
        _elapsed("the conversions")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return fwd_err, bwd_err, launches_out, rows

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
    t_start = time.perf_counter()
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

    # 10. ReStyle inversion and InterFaceGAN editing at full width.
    del pti, lpips, G, ws, targets, pivot
    torch.cuda.empty_cache()
    restyle_err, irse_ms = restyle_phase(dev, card, layers, layer_call, kernel_call)
    max_err = max(max_err, restyle_err)
    torch.cuda.empty_cache()

    # 11. Reference checkpoints: conversion, run_pti_images, ResNet ReStyle, FOV.
    t11 = time.perf_counter()
    max_err = max(max_err, checkpoint_phase(dev, card, layers, layer_call, kernel_call,
                                            irse_ms))
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"elapsed: phase 11 {now - t11:.1f} s, the script {now - t_start:.1f} s")

    # 12. StyleCLIP global directions and the video pipeline.
    t12 = time.perf_counter()
    max_err = max(max_err, styleclip_video_phase(dev, card, layers, layer_call, kernel_call))
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"elapsed: phase 12 {now - t12:.1f} s, the script {now - t_start:.1f} s")

    # 13. The editing side's training: boundary scores, the StyleCLIP mapper, MTCNN.
    t13 = time.perf_counter()
    bwd_max_err = max(bwd_max_err, editing_training_phase(dev, card, layers, bwd_kernel_call,
                                                          bwd_plain_call))
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"elapsed: phase 13 {now - t13:.1f} s, the script {now - t_start:.1f} s")

    # 14. ReStyle encoder training: the pSp coach at full width, e4e, kernels vs plain.
    t14 = time.perf_counter()
    restyle_training_phase(dev, card, len(layers))
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"elapsed: phase 14 {now - t14:.1f} s, the script {now - t_start:.1f} s")

    # 15. The evaluation side and the SetGAN generator.
    t15 = time.perf_counter()
    max_err = max(max_err, evaluation_setgan_phase(dev, card, layers, layer_call, kernel_call))
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"elapsed: phase 15 {now - t15:.1f} s, the script {now - t_start:.1f} s")

    # 16. SetGAN training at train_setgan_stem.sh's recipe.
    t16 = time.perf_counter()
    bwd_max_err = max(bwd_max_err, setgan_training_phase(dev, card, bwd_kernel_call,
                                                         bwd_plain_call))
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"elapsed: phase 16 {now - t16:.1f} s, the script {now - t_start:.1f} s")

    # 17. SetGAN's conditional FID in training; the registry's last families.
    t17 = time.perf_counter()
    setgan_fid_phase(dev, card)
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"elapsed: phase 17 {now - t17:.1f} s, the script {now - t_start:.1f} s")

    # 18. Progressive growth, the pretrained recipe, the other stems, the rosinality
    # StyleGAN2 and the last convert_checkpoint kinds.
    t18 = time.perf_counter()
    fwd18, bwd18, path18, rows18 = superres_stems_phase(dev, card, layer_call, kernel_call,
                                                        bwd_kernel_call, bwd_plain_call)
    max_err, bwd_max_err = max(max_err, fwd18), max(bwd_max_err, bwd18)
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"superres rows (batch {rows18['fwd']['batch']}, the grown decoder's 11 layers): "
          f"#1 {rows18['fwd']['ms']:.4f} ms (bound {rows18['fwd']['bound_ms']:.4f}, plain "
          f"{rows18['fwd']['plain_ms']:.4f}); #2 {rows18['bwd']['ms']:.4f} ms (bound "
          f"{rows18['bwd']['bound_ms']:.4f}, plain {rows18['bwd']['plain_ms']:.4f}) {card}")
    print(f"elapsed: phase 18 {now - t18:.1f} s, the script {now - t_start:.1f} s")

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
        "path_launches": {"phase 18 superres G forward": path18["superres G forward"],
                          "phase 18 superres train_step": path18["superres train_step"][
                              "filtered_lrelu_fwd"]},
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
        "path_launches": {"phase 18 superres train_step": path18["superres train_step"][
            "filtered_lrelu_bwd"]},
    }, fir_entry("fir_taps", "scripts/exp_mxu_down.py:56"),
        fir_entry("fir_banded", "scripts/exp_mxu_down.py:47")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
