"""Inversion fidelity: the port's ReStyle against the reference's torch path.

The port of the JAX package's `scripts/eval_inversion_fidelity.py`. N
ReStyle inversions run through the port (on the CUDA card unless
``--device cpu``) and through the reference repository's own torch modules
(on the CPU) with the same weights, and one JSON line is printed:

  lpips_ours          LPIPS(recon_ours, target), mean over images
  lpips_ref           LPIPS(recon_ref,  target), mean over images
  lpips_delta         |lpips_ours - lpips_ref|, against the 0.5 bar
  recon_max_abs_diff  max |recon_ours - recon_ref|

The reference modules (its e4e encoders and StyleGAN3 generator) are the
weights' source: random from ``--seed`` unless ``--encoder_ckpt`` /
``--generator_ckpt`` are given. They are imported from a checkout of the
reference repository, ``--reference_root``; without one the CLI raises
before any work. The port's half is
`port_restyle_from_states` → `synthesize_targets` → `invert` → `lpips_per_image`,
functions of arrays.

    python -m stylegan3_editing_tpu_torch.scripts.eval_inversion_fidelity \\
        --reference_root REF [--num 4 --n_iters 3 --resolution 1024] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..criteria import LPIPS
from ..criteria.lpips import convert_lpips_linear_state
from ..device import DeviceLike, resolve_device
from ..models.encoders import (RestyleNet, convert_restyle_encoder_state, get_average_image,
                               run_restyle_iterations)
from ..models.sg3 import SG3Config, load_jax_variables, sg3_r_config
from ..models.sg3.convert import torch_state_to_variables
from ..ops.image import adaptive_avg_pool2d

BAR = 0.5


# ---------------------------------------------------------------- reference

def load_reference_modules(root):
    """Import the reference encoders and SG3 generator from the checkout at
    ``root``, with torchvision (when absent) and the rosinality CUDA-op
    module stubbed: ``models/stylegan2/op`` compiles a CUDA extension when
    imported, and nothing on this path runs it. Raises FileNotFoundError
    when ``root`` is not a checkout."""
    if not root or not (Path(root) / "models" / "stylegan3").is_dir():
        raise FileNotFoundError(
            f"eval_inversion_fidelity needs a checkout of the reference repository "
            f"(models/stylegan3, models/setgan) as --reference_root; got {root!r}")
    root = str(root)
    if root not in sys.path:
        sys.path.insert(0, root)
    try:
        import torchvision  # noqa: F401  (a real install serves the ResNet paths)
    except ImportError:
        def _no_torchvision(*a, **k):
            raise ImportError("torchvision is not installed: ResNet* encoder types need it; "
                              "use a BackboneEncoder type or install torchvision")

        tv = types.ModuleType("torchvision")
        tvm = types.ModuleType("torchvision.models")
        tvm.resnet34 = _no_torchvision
        tv.models = tvm
        sys.modules["torchvision"] = tv
        sys.modules["torchvision.models"] = tvm
    if "models.stylegan2.op" not in sys.modules:
        op = types.ModuleType("models.stylegan2.op")
        op.FusedLeakyReLU = torch.nn.LeakyReLU
        op.fused_leaky_relu = lambda *a, **k: None
        op.upfirdn2d = lambda *a, **k: None
        sys.modules["models.stylegan2.op"] = op
    from models.setgan.encoder.encoders import restyle_e4e_encoders
    from models.stylegan3.networks_stylegan3 import Generator as TorchGenerator
    return restyle_e4e_encoders, TorchGenerator


def reference_invert(encoder, generator, targets_nchw, latent_avg, avg_image, n_iters):
    """The reference ReStyle loop in torch (run_on_batch: residual codes on
    ``latent_avg`` first, then on the previous latent; identity transform;
    fp32 synthesis; 256² face pool). Returns (images NCHW, latents), numpy."""
    n = targets_nchw.shape[0]
    face_pool = torch.nn.AdaptiveAvgPool2d((256, 256))
    y_hat = avg_image.unsqueeze(0).repeat(n, 1, 1, 1)
    latent = None
    with torch.no_grad():
        for _ in range(n_iters):
            codes = encoder(torch.cat([targets_nchw, y_hat], dim=1))
            codes = codes + (latent if latent is not None
                             else latent_avg.repeat(codes.shape[0], 1, 1))
            generator.synthesis.input.transform = torch.eye(3).unsqueeze(0).repeat(n, 1, 1).float()
            y_hat = face_pool(generator.synthesis(codes, noise_mode="const", force_fp32=True))
            latent = codes
    return y_hat.numpy(), latent.numpy()


# -------------------------------------------------------------------- port

def port_restyle_from_states(gen_state: Mapping, enc_state: Mapping, cfg: SG3Config,
                             encoder_type: str = "ProgressiveBackboneEncoder",
                             device: DeviceLike = None) -> RestyleNet:
    """A `RestyleNet` filled from a reference generator state dict (through
    `torch_state_to_variables`) and a reference encoder state dict (through
    `convert_restyle_encoder_state`)."""
    gen_vars, _ = torch_state_to_variables(gen_state, cfg)
    enc_vars, info = convert_restyle_encoder_state(enc_state)
    if info["n_styles"] != cfg.num_ws:
        raise ValueError(f"the encoder has {info['n_styles']} styles, the decoder "
                         f"{cfg.num_ws}")
    model = RestyleNet(cfg, encoder_type=encoder_type, n_styles=cfg.num_ws, input_nc=6,
                       device=device)
    variables = {col: {"decoder": gen_vars[col]} for col in ("params", "buffers", "ema")
                 if col in gen_vars}
    for col, sub in enc_vars.items():
        variables.setdefault(col, {})["encoder"] = sub
    load_jax_variables(model, variables)
    return model.eval()


def synthesize_targets(model: RestyleNet, num: int, seed: int) -> torch.Tensor:
    """``num`` decoder images at ψ 0.7 from z of a seeded `torch.Generator`
    (seed + 1), pooled to 256²: NHWC on the model's device."""
    device = model.decoder.mapping.w_avg.device
    z = torch.randn((num, model.decoder_cfg.z_dim),
                    generator=torch.Generator().manual_seed(seed + 1)).to(device)
    with torch.inference_mode():
        return adaptive_avg_pool2d(model.decoder(z, truncation_psi=0.7), 256)


def invert(model: RestyleNet, targets: torch.Tensor, n_iters: int):
    """(final aligned reconstructions NHWC, avg_image, latent_avg)."""
    with torch.inference_mode():
        avg_image, latent_avg = get_average_image(model)
        results = run_restyle_iterations(model, targets, avg_image, latent_avg, n_iters=n_iters)
    return results[-1][0], avg_image, latent_avg


def lpips_per_image(lpips: LPIPS, recon: torch.Tensor, targets: torch.Tensor) -> np.ndarray:
    with torch.inference_mode():
        return lpips.per_image(recon, targets).cpu().numpy()


def fidelity_record(lp_ours: float, lp_ref: float, recon_ours: np.ndarray,
                    recon_ref: np.ndarray, n_iters: int, resolution: int,
                    weights: Mapping[str, bool]) -> dict:
    return {
        "metric": "inversion_fidelity_lpips_delta",
        "lpips_ours": round(lp_ours, 6),
        "lpips_ref": round(lp_ref, 6),
        "lpips_delta": round(abs(lp_ours - lp_ref), 6),
        "bar": BAR,
        "pass": abs(lp_ours - lp_ref) < BAR,
        "recon_max_abs_diff": round(float(np.max(np.abs(recon_ours - recon_ref))), 6),
        "num_images": int(recon_ours.shape[0]),
        "n_iters": n_iters,
        "resolution": resolution,
        "weights": dict(weights),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Inversion fidelity: the port vs the reference torch path, LPIPS delta "
                    "against the 0.5 bar.")
    ap.add_argument("--reference_root", default=None,
                    help="checkout of the reference repository")
    ap.add_argument("--encoder_ckpt", default=None,
                    help=".pt ReStyle encoder (released format); default: random init")
    ap.add_argument("--generator_ckpt", default=None,
                    help="SG3 generator .pt state dict; default: random init")
    ap.add_argument("--lpips_heads", default=None,
                    help="richzhang linear-head .pt for LPIPS(alex); default: uniform heads")
    ap.add_argument("--data", default=None,
                    help="folder of target images; default: the generator's own images")
    ap.add_argument("--num", type=int, default=4)
    ap.add_argument("--n_iters", type=int, default=3)
    ap.add_argument("--resolution", type=int, default=1024)
    ap.add_argument("--channel_base", type=int, default=None)
    ap.add_argument("--channel_max", type=int, default=None)
    ap.add_argument("--num_layers", type=int, default=None)
    ap.add_argument("--encoder_type", default="ProgressiveBackboneEncoder")
    ap.add_argument("--encoder_depth", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--device", default=None, help="cuda unless 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ref_enc_mod, TorchGenerator = load_reference_modules(args.reference_root)
    torch.manual_seed(args.seed)
    overrides = {k: v for k, v in (("channel_base", args.channel_base),
                                   ("channel_max", args.channel_max),
                                   ("num_layers", args.num_layers)) if v is not None}
    cfg = sg3_r_config(args.resolution, use_bf16=False, **overrides)

    # The reference modules: the weights' source.
    tgen = TorchGenerator(
        z_dim=cfg.z_dim, c_dim=0, w_dim=cfg.w_dim, img_resolution=cfg.img_resolution,
        img_channels=cfg.img_channels, channel_base=cfg.channel_base,
        channel_max=cfg.channel_max, num_layers=cfg.num_layers, num_critical=cfg.num_critical,
        conv_kernel=cfg.conv_kernel, use_radial_filters=cfg.use_radial_filters,
        output_scale=cfg.output_scale, magnitude_ema_beta=cfg.magnitude_ema_beta).eval()
    if args.generator_ckpt:
        state = torch.load(args.generator_ckpt, map_location="cpu", weights_only=True)
        tgen.load_state_dict(state.get("g_ema", state.get("state_dict", state)))
    tenc = ref_enc_mod.ProgressiveBackboneEncoder(args.encoder_depth, "ir_se",
                                                  n_styles=cfg.num_ws, input_nc=6).eval()
    if args.encoder_ckpt:
        from ..models.encoders import encoder_state_from_model_checkpoint

        ckpt = torch.load(args.encoder_ckpt, map_location="cpu", weights_only=True)
        tenc.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                              encoder_state_from_model_checkpoint(ckpt).items()})
    gen_state = {k: v.detach().numpy() for k, v in tgen.state_dict().items()}
    enc_state = {k: v.detach().numpy() for k, v in tenc.state_dict().items()}

    model = port_restyle_from_states(gen_state, enc_state, cfg, args.encoder_type, device)
    if args.data:
        from PIL import Image

        paths = [p for p in sorted(Path(args.data).rglob("*")) if p.is_file()
                 and p.suffix.lower() in {".png", ".jpg", ".jpeg"}][:args.num]
        targets = torch.from_numpy(np.stack([
            np.asarray(Image.open(p).convert("RGB").resize((256, 256)), np.float32) / 127.5 - 1
            for p in paths])).to(device)
    else:
        targets = synthesize_targets(model, args.num, args.seed)
    recon, avg_image, latent_avg = invert(model, targets, args.n_iters)

    recon_ref_nchw, _ = reference_invert(
        tenc, tgen, targets.cpu().permute(0, 3, 1, 2).contiguous(), latent_avg.cpu(),
        avg_image.cpu().permute(2, 0, 1).contiguous(), args.n_iters)
    recon_ref = torch.from_numpy(recon_ref_nchw.transpose(0, 2, 3, 1).copy()).to(device)

    lpips = LPIPS("alex", device=device, generator=torch.Generator().manual_seed(2)).eval()
    if args.lpips_heads:
        heads = torch.load(args.lpips_heads, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for name, w in convert_lpips_linear_state(
                    {k: v.numpy() for k, v in heads.items()}).items():
                getattr(lpips, name).copy_(torch.from_numpy(w))
    lp_ours = float(np.mean(lpips_per_image(lpips, recon, targets)))
    lp_ref = float(np.mean(lpips_per_image(lpips, recon_ref, targets)))
    record = fidelity_record(lp_ours, lp_ref, recon.cpu().numpy(), recon_ref.cpu().numpy(),
                             args.n_iters, args.resolution,
                             {"encoder": bool(args.encoder_ckpt),
                              "generator": bool(args.generator_ckpt),
                              "lpips_heads": bool(args.lpips_heads)})
    line = json.dumps(record)
    print(line)
    if args.out:
        Path(args.out).write_text(line)
    return record


if __name__ == "__main__":
    main()
