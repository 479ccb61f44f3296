"""Convert reference checkpoints to the flat ``.npz`` archives of both packages.

The port of the JAX package's `scripts/convert_checkpoint.py`, numpy and
torch only, so a reference checkpoint converts on a machine without JAX:

  SG3 generator pickles (official or TF1, ``--kind sg3``, ``.pkl``) through
      the allowlist unpickler (`models/sg3/persistence.py`), the config read
      from the pickle's captured ``init_kwargs``;
  SG3 ``.pt`` state dicts (``--kind sg3``), the config from
      ``--preset/--res/--cfg``;
  ReStyle encoder checkpoints (``--kind encoder``: released
      ``restyle_{psp,e4e}`` weights or the ``encoder.*`` keys of a
      full-model checkpoint), the trunk (IR, IR-SE or ResNet-34), its depth
      and the style count read off the keys;
  NVIDIA-convention StyleGAN2 stems (``--kind sg2_stem``, for SetGAN's
      ``"sg2"`` stem; `models/sg2_stem.convert_sg2_state`), the config
      from ``--res/--cfg``;
  timm/torchvision feature backbones (``--kind backbone --name NAME``, a
      registry name; `models/backbones/registry.convert_feature_network_state`);
  ImageNet class embeddings (``--kind class_embedding``, the reference's
      ``in_embeddings/*.pkl``; `models/sg3/superres.load_class_embedding`).

It writes what the JAX CLI writes: ``<dst>.npz`` (read by
`models.sg3.convert.npz_to_variables` in either package) and ``<dst>.json``.
An encoder's ``.npz`` holds the encoder alone, which `load_encoder` does not
read, so ``--kind encoder`` also writes ``<dst>_checkpoint``, a checkpoint
in the numpy format (`runtime.checkpoint`) that `load_encoder` reads: the
encoder, the decoder when the file holds ``decoder.*`` keys (else pass
``generator_variables`` to `load_encoder`), and the options. The encoder
type is the checkpoint's ``opts.encoder_type``, else the e4e type of its
trunk.

    python -m stylegan3_editing_tpu_torch.scripts.convert_checkpoint \\
        --src stylegan3-r-ffhq-1024x1024.pkl --dst sg3r_ffhq
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..models.sg3.config import sg3_r_config, sg3_t_config
from ..models.sg3.convert import (as_numpy, pkl_generator_state, torch_state_to_variables,
                                  variables_to_npz)

_CFG_KEYS = ("z_dim", "c_dim", "w_dim", "img_channels", "channel_base",
             "channel_max", "num_layers", "num_critical", "conv_kernel",
             "filter_size", "use_radial_filters", "output_scale",
             "margin_size", "first_cutoff", "first_stopband",
             "last_stopband_rel", "magnitude_ema_beta")
KINDS = ("sg3", "encoder", "sg2_stem", "backbone", "class_embedding")


def _detect_kind(src: str, state=None) -> str:
    if src.endswith(".pkl"):
        return "sg3"
    if state is not None:
        keys = list(state)
        if any(k.startswith(("input_layer.", "conv1.")) for k in keys) and \
                any(k.startswith("styles.") for k in keys):
            return "encoder"
        if any(k.startswith("synthesis.input.") for k in keys):
            return "sg3"
        if any(k.startswith("synthesis.b4.") for k in keys):
            return "sg2_stem"
    raise SystemExit("cannot auto-detect checkpoint kind; pass --kind")


def _sg3_cfg(preset: str, res: int, overrides: dict):
    make = sg3_r_config if preset == "sg3-r" else sg3_t_config
    return make(res, use_bf16=False, **overrides)


def _sg3_meta(meta: dict, cfg, transform) -> None:
    meta["decoder_cfg"] = dataclasses.asdict(cfg)
    meta["transform"] = np.asarray(transform).tolist() if transform is not None else None


def _encoder_checkpoint(dst: str, ckpt: dict, state: dict, enc_state: dict, variables: dict,
                        info: dict, preset: str, res: int, overrides: dict) -> str:
    """Write the numpy-format checkpoint `load_encoder` reads; its path."""
    from ..runtime.checkpoint import save_pytree
    from ..training.options import E4eTrainOptions, TrainOptions

    saved = dict(ckpt.get("opts") or {}) if "state_dict" in ckpt else {}
    resnet = info["trunk"] == "resnet34"
    encoder_type = saved.get("encoder_type") or (
        "ResNetProgressiveBackboneEncoder" if resnet else "ProgressiveBackboneEncoder")
    is_e4e = "Progressive" in encoder_type
    opts_cls = E4eTrainOptions if is_e4e else TrainOptions
    fields = {f.name for f in dataclasses.fields(opts_cls)}
    first_conv = enc_state["conv1.weight" if resnet else "input_layer.0.weight"]
    kwargs = {k: v for k, v in saved.items() if k in fields}
    kwargs.update(encoder_type=encoder_type, input_nc=int(first_conv.shape[1]),
                  output_size=int(saved.get("output_size", res)))
    for key in ("channel_base", "channel_max", "num_layers"):
        if key in overrides:
            kwargs[f"decoder_{key}"] = overrides[key]
    opts = opts_cls(**kwargs)

    tree = {"params": {"encoder": variables["params"]},
            "batch_stats": {"encoder": variables["batch_stats"]}}
    decoder = {k[len("decoder."):]: v for k, v in state.items() if k.startswith("decoder.")}
    if decoder:
        cfg_overrides = {k: v for k, v in overrides.items() if k in _CFG_KEYS}
        dec, _ = torch_state_to_variables(decoder, _sg3_cfg(preset, opts.output_size,
                                                            cfg_overrides))
        for coll in ("params", "buffers", "ema"):
            tree.setdefault(coll, {})["decoder"] = dec[coll]
    path = str(Path(dst).with_suffix("")) + "_checkpoint"
    save_pytree(path, {"variables": tree}, {"opts": dataclasses.asdict(opts), "is_e4e": is_e4e})
    return path


def convert(src: str, dst: str, kind: str = "auto", preset: str = "sg3-r",
            res: int = 1024, name: str = "", entry: str = "G_ema",
            cfg_overrides: Optional[dict] = None, strict: bool = True) -> dict:
    """Convert ``src`` and write ``<dst>.npz`` and ``<dst>.json``; returns the
    metadata. ``name``: the registry name of a ``backbone``."""
    overrides = dict(cfg_overrides or {})
    meta: dict = {"src": src, "kind": kind}

    ckpt, state = {}, None
    if src.endswith((".pt", ".pth")) and kind != "class_embedding":
        import torch

        ckpt = torch.load(src, map_location="cpu", weights_only=True)
        wrapped = isinstance(ckpt, dict) and "state_dict" in ckpt
        state = {k: as_numpy(v) for k, v in (ckpt["state_dict"] if wrapped else ckpt).items()}
    if kind == "auto":
        kind = _detect_kind(src, state)
        meta["kind"] = kind

    if kind == "sg3" and src.endswith(".pkl"):
        state, init_kwargs = pkl_generator_state(src, entry)
        # The captured constructor kwargs override the preset (official SG3
        # pickles carry the whole synthesis config at the top level).
        for k in _CFG_KEYS:
            if k in init_kwargs and k not in overrides:
                overrides[k] = init_kwargs[k]
        cfg = _sg3_cfg(preset, int(init_kwargs.get("img_resolution", res)), overrides)
        variables, transform = torch_state_to_variables(state, cfg, strict=strict)
        _sg3_meta(meta, cfg, transform)
    elif kind == "sg3":
        cfg = _sg3_cfg(preset, res, overrides)
        variables, transform = torch_state_to_variables(state, cfg, strict=strict)
        _sg3_meta(meta, cfg, transform)
    elif kind == "encoder":
        from ..models.encoders import (convert_restyle_encoder_state,
                                       encoder_state_from_model_checkpoint)

        enc_state = encoder_state_from_model_checkpoint(state)
        variables, info = convert_restyle_encoder_state(enc_state)
        meta["encoder"] = info
        meta["checkpoint"] = _encoder_checkpoint(dst, ckpt, state, enc_state, variables, info,
                                                 preset, res, overrides)
    elif kind == "sg2_stem":
        from ..models.sg2_stem import SG2Config, convert_sg2_state

        cfg = SG2Config(img_resolution=res, use_bf16=False, **overrides)
        variables = convert_sg2_state(state, cfg)
        meta["decoder_cfg"] = dataclasses.asdict(cfg)
    elif kind == "backbone":
        from ..models.backbones.registry import convert_feature_network_state

        if not name:
            raise SystemExit("--kind backbone needs --name <registry name>")
        variables = convert_feature_network_state(name, state)
        meta["backbone"] = name
    elif kind == "class_embedding":
        from ..models.sg3.superres import load_class_embedding

        emb = load_class_embedding(src)
        variables = {"class_embedding": emb}
        meta["shape"] = list(emb.shape)
    else:
        raise SystemExit(f"unknown kind {kind!r}")

    dst = dst if dst.endswith(".npz") else dst + ".npz"
    variables_to_npz(variables, dst)
    with open(Path(dst).with_suffix(".json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    print(f"wrote {dst} ({meta['kind']})")
    return meta


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--kind", default="auto", choices=["auto", *KINDS])
    p.add_argument("--preset", default="sg3-r", choices=["sg3-r", "sg3-t"])
    p.add_argument("--res", type=int, default=1024)
    p.add_argument("--name", default="", help="backbone registry name")
    p.add_argument("--entry", default="G_ema", help="pickle entry to convert")
    p.add_argument("--cfg", default="", help="JSON config overrides")
    p.add_argument("--no-strict", action="store_true")
    a = p.parse_args(argv)
    return convert(a.src, a.dst, kind=a.kind, preset=a.preset, res=a.res, name=a.name,
                   entry=a.entry,
                   cfg_overrides=json.loads(a.cfg) if a.cfg else None,
                   strict=not a.no_strict)


if __name__ == "__main__":
    main()
