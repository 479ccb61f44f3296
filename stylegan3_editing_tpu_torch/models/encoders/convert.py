"""Pretrained ReStyle encoder checkpoint converter (IR, IR-SE and ResNet-34 trunks).

Counterpart of the JAX package's `models/encoders/convert.py`: maps the
reference's released encoder state dicts, pSp/e4e over an IR(-SE) trunk
(restyle_psp_encoders.BackboneEncoder, restyle_e4e_encoders.
ProgressiveBackboneEncoder) or over the ResNet-34 trunk (ResNetBackboneEncoder,
ResNetProgressiveBackboneEncoder), onto the tree of `backbones.py`, so a
reference ReStyle ``.pt`` loads with ``torch.load(path, weights_only=True)``
and `load_jax_variables`. Plain and progressive encoders share one tree.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np

from ..backbones.common import bn_from_torch, conv_w, put
from ..backbones.irse import convert_irse_body_state
from ..backbones.resnet import RESNET34_LAYERS, convert_resnet34_body_state
from ..sg3.convert import as_numpy

# body block-count → IR depth (helpers.get_blocks: 3+4+14+3 etc.).
_IR_DEPTH_BY_BLOCKS = {24: 50, 49: 100, 50: 152}


def _style_count(state: Mapping[str, np.ndarray]) -> int:
    idx = {int(k.split(".")[1]) for k in state if k.startswith("styles.")}
    assert idx, "no styles.* heads in the encoder state dict"
    assert idx == set(range(max(idx) + 1)), f"non-contiguous style heads {idx}"
    return max(idx) + 1


def _convert_styles(state, params) -> int:
    n_styles = _style_count(state)
    for j in range(n_styles):
        k = 0
        while f"styles.{j}.convs.{2 * k}.weight" in state:
            put(params, f"style_{j}/conv{k}/kernel",
                conv_w(state[f"styles.{j}.convs.{2 * k}.weight"]))
            put(params, f"style_{j}/conv{k}/bias", state[f"styles.{j}.convs.{2 * k}.bias"])
            k += 1
        assert k > 0, f"style head {j} has no convs"
        # EqualLinear(lr_mul=1) ≡ FullyConnected: [out, in] weight, 1:1 map.
        put(params, f"style_{j}/linear/weight", state[f"styles.{j}.linear.weight"])
        put(params, f"style_{j}/linear/bias", state[f"styles.{j}.linear.bias"])
    return n_styles


def convert_restyle_encoder_state(state: Mapping) -> Tuple[dict, dict]:
    """torch ReStyle encoder state dict → (variables, info).

    IR depth, IR vs IR-SE and the style count are read off the keys.
    Returns ``{'params', 'batch_stats'}`` matching `BackboneEncoder` /
    `ProgressiveBackboneEncoder` (or their ResNet-34 twins), and
    ``{trunk, n_styles[, num_layers, mode]}``.
    """
    state = {k: as_numpy(v) for k, v in state.items()}
    if "input_layer.0.weight" in state:
        n_body = len({int(k.split(".")[1]) for k in state if k.startswith("body.")})
        num_layers = _IR_DEPTH_BY_BLOCKS.get(n_body)
        assert num_layers is not None, f"unrecognized IR body size {n_body}"
        mode = "ir_se" if "body.0.res_layer.5.fc1.weight" in state else "ir"
        trunk_p, trunk_s = convert_irse_body_state(state, num_layers)
        info = {"trunk": "irse", "num_layers": num_layers, "mode": mode}
    elif "conv1.weight" in state:
        trunk_p, trunk_s = {}, {}
        put(trunk_p, "conv1/kernel", conv_w(state["conv1.weight"]))
        bn_from_torch(trunk_p, trunk_s, "bn1", state, "bn1")
        put(trunk_p, "relu/alpha", state["relu.weight"])
        # The reference flattens layer1-4 into one Sequential (body.N); name
        # each block as torchvision does (layerN.M) for the body converter.
        body_state = {}
        flat = 0
        for stage_i, (blocks, _) in enumerate(RESNET34_LAYERS, start=1):
            for block_i in range(blocks):
                pfx = f"body.{flat}."
                body_state.update({f"layer{stage_i}.{block_i}.{k[len(pfx):]}": v
                                   for k, v in state.items() if k.startswith(pfx)})
                flat += 1
        body = convert_resnet34_body_state(body_state)
        trunk_p["body"], trunk_s["body"] = body["params"], body["batch_stats"]
        info = {"trunk": "resnet34"}
    else:
        raise ValueError("state dict is neither an IR(-SE) nor a ResNet "
                         "ReStyle encoder (no input_layer.0 / conv1 keys)")
    params: dict = {"trunk": trunk_p}
    info["n_styles"] = _convert_styles(state, params)
    return {"params": params, "batch_stats": {"trunk": trunk_s}}, info


def encoder_state_from_model_checkpoint(ckpt: Mapping, prefix: str = "encoder.") -> Mapping:
    """Slice an encoder sub-state out of a full-model checkpoint
    (reference SetGAN._get_keys, models/setgan/setgan.py:272-278)."""
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    out = {k[len(prefix):]: v for k, v in ckpt.items() if k.startswith(prefix)}
    return out if out else ckpt
