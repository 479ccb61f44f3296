"""The converters and layouts of the registry's DenseNet, MobileNetV2, MNASNet,
ShuffleNetV2, RegNetX/Y and CLIP families against the JAX package's, on the CPU.

Each converter on a seeded state dict in torchvision's, timm's or OpenAI's
naming (built from the port's names by the rules below): the port's tree
equals the JAX package's leaf for leaf and loads into the port. The
transposed convs of the CLIP heads against flax's ``nn.ConvTranspose``
with a kernel that is not symmetric (tolerance 1e-5 of max |ref|: one fp32
product each), and the channel shuffle against the JAX package's and
against torchvision's NCHW shuffle read in NHWC, which is another
permutation.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.backbones import registry as jreg
from stylegan3_editing_tpu.models.backbones import shufflenet as jshuffle
from stylegan3_editing_tpu_torch.models.backbones import registry as preg
from stylegan3_editing_tpu_torch.models.backbones import shufflenet as pshuffle
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables, to_jax_variables

torch.set_num_threads(1)

# ------------------------------------------------------------------ converters

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_MBV2_T1 = {"conv_dw": "0.0", "bn2": "0.1", "conv_pwl": "1", "bn3": "2"}
_MBV2 = {"conv_pw": "0.0", "bn1": "0.1", "conv_dw": "1.0", "bn2": "1.1", "conv_pwl": "2",
         "bn3": "3"}
_MNAS = {"conv_pw": 0, "bn1": 1, "conv_dw": 3, "bn2": 4, "conv_pwl": 6, "bn3": 7}
_SHUFFLE = {"b1_dw": "branch1.0", "b1_bn1": "branch1.1", "b1_pw": "branch1.2",
            "b1_bn2": "branch1.3", "b2_pw1": "branch2.0", "b2_bn1": "branch2.1",
            "b2_dw": "branch2.3", "b2_bn2": "branch2.4", "b2_pw2": "branch2.5",
            "b2_bn3": "branch2.6"}


def _torch_module(family, path):
    """The port's module path → the torch module's dotted name."""
    if family == "densenet":
        m = re.match(r"^block(\d+)_layer(\d+)\.(\w+)$", path)
        if m:
            return f"features.denseblock{int(m[1]) + 1}.denselayer{int(m[2]) + 1}.{m[3]}"
        m = re.match(r"^trans(\d)_(norm|conv)$", path)
        return f"features.transition{int(m[1]) + 1}.{m[2]}" if m else f"features.{path}"
    if family == "mobilenet":
        stem = {"conv_stem": "features.0.0", "bn_stem": "features.0.1"}
        if path in stem:
            return stem[path]
        block, layer = path.split(".")
        i = int(block[len("block"):])
        return f"features.{i}.conv.{(_MBV2_T1 if i == 1 else _MBV2)[layer]}"
    if family == "mnasnet":
        stem = {"conv_stem": 0, "bn_stem": 1, "conv_sep_dw": 3, "bn_sep_dw": 4,
                "conv_sep_pw": 6, "bn_sep_pw": 7}
        if path in stem:
            return f"layers.{stem[path]}"
        m = re.match(r"^stack(\d)_(\d+)\.(\w+)$", path)
        return f"layers.{8 + int(m[1])}.{m[2]}.layers.{_MNAS[m[3]]}"
    if family == "shufflenet":
        if path in ("conv1", "bn1"):
            return {"conv1": "conv1.0", "bn1": "conv1.1"}[path]
        m = re.match(r"^stage(\d)_(\d+)\.(\w+)$", path)
        return f"stage{m[1]}.{m[2]}.{_SHUFFLE[m[3]]}"
    if family == "regnet":
        if path.startswith("stem_"):
            return f"stem.{path[len('stem_'):]}"
        m = re.match(r"^s(\d)_b(\d+)\.(\w+)$", path)
        block, layer = f"s{m[1]}.b{m[2]}", m[3]
        sub = re.match(r"^(conv|bn)(\d)$", layer)
        if sub:
            return f"{block}.conv{sub[2]}.{'conv' if sub[1] == 'conv' else 'bn'}"
        if layer.startswith("se_fc"):
            return f"{block}.se.fc{layer[-1]}"
        return f"{block}.downsample.{'conv' if layer == 'down_conv' else 'bn'}"
    if family == "clip_resnet":
        m = re.match(r"^stem_(conv|bn)(\d)$", path)
        if m:
            return f"visual.{m[1]}{m[2]}"
        m = re.match(r"^layer(\d)_(\d+)\.(\w+)$", path)
        layer = {"down_conv": "downsample.0", "down_bn": "downsample.1"}.get(m[3], m[3])
        return f"visual.layer{m[1]}.{m[2]}.{layer}"
    raise ValueError(family)


def _clip_vit_key(key):
    """The port's CLIP ViT name → OpenAI's (None: a stage head, not in the state)."""
    if key.startswith("head"):
        return None
    fixed = {"visual_conv1.kernel": "visual.conv1.weight",
             "class_embedding": "visual.class_embedding",
             "visual_positional_embedding": "visual.positional_embedding",
             "ln_pre.scale": "visual.ln_pre.weight", "ln_pre.bias": "visual.ln_pre.bias"}
    if key in fixed:
        return fixed[key]
    m = re.match(r"^visual_transformer\.resblock_(\d+)\.(.+)\.(\w+)$", key)
    block, module, leaf = f"visual.transformer.resblocks.{m[1]}", m[2], m[3]
    if module in ("attn.in_proj",):
        return f"{block}.attn.in_proj_{'weight' if leaf == 'kernel' else 'bias'}"
    module = {"c_fc": "mlp.c_fc", "c_proj": "mlp.c_proj"}.get(module, module)
    return f"{block}.{module}.{'weight' if leaf in ('kernel', 'scale') else 'bias'}"


def torch_state(name, port):
    """A seeded state dict in the torch family's naming for ``port``."""
    family = ("densenet" if name.startswith("densenet") else
              "mobilenet" if name == "mobilenet_v2" else
              "mnasnet" if name.startswith("mnasnet") else
              "shufflenet" if name.startswith("shufflenet") else
              "regnet" if name.startswith("regnet") else
              "clip_resnet" if name == "resnet50_clip" else "clip_vit")
    rng = np.random.default_rng(9)
    state = {}
    for key, value in port.state_dict().items():
        v = rng.standard_normal(tuple(value.shape)).astype(np.float32)
        if family == "clip_vit":
            theirs = _clip_vit_key(key)
            if theirs is not None:
                state[theirs] = (v.transpose(3, 2, 0, 1) if v.ndim == 4 else
                                 v.T if v.ndim == 2 and theirs.endswith("weight") else v)
            continue
        path, _, leaf = key.rpartition(".")
        module = _torch_module(family, path)
        if leaf == "kernel":
            state[f"{module}.weight"] = v.transpose(3, 2, 0, 1)
        elif leaf == "bias" and (".se." in module or ".se_" in module):
            state[f"{module}.bias"] = v
        else:
            state[f"{module}.{_BN[leaf]}"] = v
    return state


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["densenet121", "mobilenet_v2", "mnasnet0_5", "mnasnet1_0",
                                  "shufflenet_v2_x0_5", "regnetx_002", "regnety_002",
                                  "resnet50_clip", "clip_vit_b32"])
def test_converters_match_jax(name):
    port, _ = preg.make_feature_network(name, generator=torch.Generator().manual_seed(1))
    state = torch_state(name, port)
    got = preg.convert_feature_network_state(name, state)
    want = jreg.convert_feature_network_state(name, state)
    assert got.keys() == want.keys()
    for coll in got:
        flat_got, flat_want = _flat(got[coll]), _flat(want[coll])
        assert flat_got.keys() == flat_want.keys(), coll
        for k, v in flat_want.items():
            np.testing.assert_array_equal(flat_got[k], v, err_msg=k)
    if name == "clip_vit_b32":  # the trunk only: the heads keep the module's own init
        own = to_jax_variables(port)
        own["params"].update(got["params"])
        got = own
    if name == "resnet50_clip":  # OpenAI's keys carry "visual."; bare ones read alike
        bare = preg.convert_feature_network_state(
            name, {k[len("visual."):]: v for k, v in state.items()})
        for coll in got:
            assert _flat(bare[coll]).keys() == _flat(got[coll]).keys()
    load_jax_variables(port, got)


# ------------------------------------------------------------------ layouts

@pytest.mark.parametrize("k", [2, 4, 8])
def test_conv_transpose_takes_flax_kernel_unflipped(k):
    """The CLIP heads' ×k transposed conv equals flax's ``nn.ConvTranspose``
    (which does not flip its kernel) on a kernel that is not symmetric; the
    kernel taken flipped gives another result."""
    from flax import linen as fnn

    from stylegan3_editing_tpu_torch.models.backbones.deit import ConvTranspose

    rng = np.random.RandomState(k)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    conv = ConvTranspose(5, 6, k, generator=torch.Generator().manual_seed(k))
    kernel = conv.kernel.detach().numpy()
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    with torch.no_grad():
        conv.bias.copy_(torch.from_numpy(rng.randn(6).astype(np.float32)))
        got = conv(torch.from_numpy(x)).numpy()
    flax_conv = fnn.ConvTranspose(6, (k, k), strides=(k, k))
    want = np.asarray(flax_conv.apply({"params": {"kernel": kernel,
                                                  "bias": conv.bias.detach().numpy()}}, x))
    assert got.shape == want.shape == (2, 3 * k, 4 * k, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    flipped = np.asarray(flax_conv.apply({"params": {"kernel": kernel[::-1, ::-1].copy(),
                                                     "bias": conv.bias.detach().numpy()}}, x))
    assert np.abs(got - flipped).max() > 1e-2 * np.abs(want).max()


def test_channel_shuffle_order():
    """`_shuffle` is the JAX package's NHWC shuffle; torchvision's
    ``channel_shuffle`` equals it on the NCHW view, and read straight on an
    NHWC tensor it shuffles another axis."""
    x = np.random.RandomState(0).randn(2, 4, 6, 8).astype(np.float32)
    got = pshuffle._shuffle(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jshuffle._shuffle(jnp.asarray(x))))

    def torchvision_shuffle(t, groups=2):  # torchvision's, on [N, C, H, W]
        b, c, h, w = t.shape
        return t.view(b, groups, c // groups, h, w).transpose(1, 2).contiguous().view(b, c, h, w)

    nchw = torchvision_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), got.numpy())
    misread = torchvision_shuffle(torch.from_numpy(x))
    assert not torch.equal(misread, got)
    assert torch.equal(got[..., 1], torch.from_numpy(x)[..., 4])  # channel 2i+g ← g·C/2+i
