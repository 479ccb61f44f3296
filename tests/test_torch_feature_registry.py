"""Parity of the port's feature-network registry with the JAX package's, on the CPU.

Each ported family's four feature stages against the JAX module on the same
seeded variables (numpy, carried into the port by `load_jax_variables`)
and the same input: DeiT-tiny at full depth and one DeiT-base image at
224²; EfficientNet lite0 and b0 at 64²; ResNet-18, -34, -50, ResNet-26d
(the deep stem and the average-pool downsample) and SE-ResNet-50 at 32²;
VGG16 and VGG16-BN at 32². Kernels are normal with std 1/sqrt(fan in),
batch-norm statistics non-trivial, biases, affines and tokens non-zero.

Tolerance: each stage within 1e-5 of its max |ref| (fp32 sum order; the
JAX convs run in XLA, the port's in PyTorch's convolution).

Each converter runs on a seeded state dict in timm's or torchvision's
naming, built from the port module's own names; the port's tree equals
the JAX package's leaf for leaf and loads into the port module. The
registry lists the JAX package's names, and every one builds (the families
of `test_torch_feature_registry_more.py` and its two siblings included).
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.backbones import registry as jreg
from stylegan3_editing_tpu_torch.models.backbones import registry as preg
from stylegan3_editing_tpu_torch.models.backbones.deit import DeiTTinyFeatures
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables, to_jax_variables

torch.set_num_threads(1)

STAGE_TOL = 1e-5
FAMILIES = {  # name: (input side, batch)
    "deit_tiny_distilled_patch16_224": (224, 2),
    "deit_base_distilled_patch16_224": (224, 1),
    "tf_efficientnet_lite0": (64, 2),
    "tf_efficientnet_b0": (64, 2),
    "resnet18": (32, 2),
    "resnet34": (32, 2),
    "resnet50": (32, 2),
    "resnet26d": (32, 2),
    "seresnet50": (32, 2),
    "vgg16": (32, 2),
    "vgg16_bn": (32, 2),
}


def seed_tree(shapes, seed):
    """A numpy tree shaped as ``shapes`` (a `jax.eval_shape` tree), leaves by name."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [p.key for p in path]
        shape, last = leaf.shape, names[-1]
        z = rng.standard_normal(shape, dtype=np.float32)
        if names[0] == "batch_stats":
            v = 0.1 * z if last == "mean" else 0.5 + np.abs(z)
        elif last == "kernel":
            v = z / math.sqrt(math.prod(shape[:-1]))
        elif last == "scale":
            v = 1 + 0.1 * z
        else:  # biases, the prefix tokens, the position embedding
            v = 0.1 * z
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _input(side, batch, seed=0):
    return np.random.RandomState(seed).randn(batch, side, side, 3).astype(np.float32)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_stages_match_jax(name):
    side, batch = FAMILIES[name]
    x = _input(side, batch)
    jmod, _ = jreg.make_feature_network(name)
    variables = seed_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                          seed=len(name))
    want = jax.jit(jmod.apply)(variables, x)
    port, spec = preg.make_feature_network(name, generator=torch.Generator().manual_seed(0))
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and w.shape[-1] == spec.channels[i], (i, g.shape)
        err, scale = float(np.abs(g.numpy() - w).max()), float(np.abs(w).max())
        print(f"{name} stage {i} {w.shape}: max abs err {err:.3g}, max |ref| {scale:.3g}")
        assert err <= STAGE_TOL * scale, (name, i)


def test_available_lists_the_jax_names_and_slice_17_raises():
    assert preg.available() == jreg.available()
    for name in preg.available():
        assert preg.get_spec(name).channels == tuple(jreg.get_spec(name).channels), name
        assert preg.get_spec(name).fixed_input_res == jreg.get_spec(name).fixed_input_res
        np.testing.assert_array_equal(preg.get_spec(name).mean, jreg.get_spec(name).mean)
    for name in preg.available():  # every name builds (on the meta device: no weights drawn)
        with torch.device("meta"):
            net, spec = preg.make_feature_network(name)
        assert spec.name == name and sum(p.numel() for p in net.parameters()) > 0, name
    assert not hasattr(preg, "SLICE_17_NAMES") and not hasattr(preg, "_not_ported")
    with pytest.raises(KeyError):
        preg.get_spec("no_such_net")


def test_deit_takes_224_only():
    """The JAX position-embedding interpolation (an antialiased resize) is
    not ported: other sizes raise instead of resizing."""
    net = DeiTTinyFeatures(generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="224"):
        net(torch.zeros((1, 256, 256, 3)))


# ------------------------------------------------------------------ converters

def _oihw(v):
    return v.transpose(3, 2, 0, 1)


_RULES = {  # (pattern on the port's dotted name, torch name, layout)
    "resnet": [
        (r"^conv1_0\.kernel$", "conv1.0.weight", _oihw),
        (r"^bn1_0\.(\w+)$", r"conv1.1.\1", None),
        (r"^conv1_1\.kernel$", "conv1.3.weight", _oihw),
        (r"^bn1_1\.(\w+)$", r"conv1.4.\1", None),
        (r"^conv1_2\.kernel$", "conv1.6.weight", _oihw),
        (r"^layer(\d)_(\d+)\.se_fc(\d)\.kernel$", r"layer\1.\2.se.fc\3.weight", _oihw),
        (r"^layer(\d)_(\d+)\.se_fc(\d)\.bias$", r"layer\1.\2.se.fc\3.bias", None),
        (r"^layer(\d)_(\d+)\.down_conv\.kernel$", r"layer\1.\2.downsample.{dc}.weight", _oihw),
        (r"^layer(\d)_(\d+)\.down_bn\.(\w+)$", r"layer\1.\2.downsample.{db}.\3", None),
        (r"^layer(\d)_(\d+)\.(\w+)\.kernel$", r"layer\1.\2.\3.weight", _oihw),
        (r"^layer(\d)_(\d+)\.(bn\d)\.(\w+)$", r"layer\1.\2.\3.\4", None),
        (r"^conv1\.kernel$", "conv1.weight", _oihw),
        (r"^bn1\.(\w+)$", r"bn1.\1", None),
    ],
    "efficientnet": [
        (r"^blocks_(\d)_(\d+)\.(.+)\.kernel$", r"blocks.\1.\2.\3.weight", _oihw),
        (r"^blocks_(\d)_(\d+)\.(.+)\.(\w+)$", r"blocks.\1.\2.\3.\4", None),
        (r"^conv_stem\.kernel$", "conv_stem.weight", _oihw),
        (r"^bn1\.(\w+)$", r"bn1.\1", None),
    ],
    "deit": [
        (r"^patch_embed\.kernel$", "patch_embed.proj.weight", _oihw),
        (r"^patch_embed\.bias$", "patch_embed.proj.bias", None),
        (r"^block(\d+)\.(norm\d)\.scale$", r"blocks.\1.\2.weight", None),
        (r"^block(\d+)\.(norm\d)\.bias$", r"blocks.\1.\2.bias", None),
        (r"^block(\d+)\.(qkv|proj)\.kernel$", r"blocks.\1.attn.\2.weight", np.transpose),
        (r"^block(\d+)\.(qkv|proj)\.bias$", r"blocks.\1.attn.\2.bias", None),
        (r"^block(\d+)\.(fc\d)\.kernel$", r"blocks.\1.mlp.\2.weight", np.transpose),
        (r"^block(\d+)\.(fc\d)\.bias$", r"blocks.\1.mlp.\2.bias", None),
        (r"^(cls_token|dist_token|pos_embed)$", r"\1", None),
    ],
}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def torch_state(name, port):
    """A seeded state dict in timm's or torchvision's naming for ``port``'s
    parameters and statistics (the DeiT heads have no counterpart there)."""
    rng = np.random.default_rng(7)
    family = ("deit" if "deit" in name else "efficientnet" if "efficientnet" in name
              else "vgg" if "vgg" in name else "resnet")
    avg_down = name.endswith("d")
    vgg_index, state = {}, {}
    if family == "vgg":  # features.N: conv [+ bn] + relu per conv, a pool per stage
        theirs = 0
        for stage_i, widths in enumerate(port.net.stages):
            theirs += stage_i > 0
            for _ in widths:
                vgg_index[len(vgg_index)] = theirs
                theirs += 3 if port.net.bn else 2
    for key, value in port.state_dict().items():
        value = rng.standard_normal(tuple(value.shape)).astype(np.float32)
        if family == "vgg":
            m = re.match(r"^net\.(conv|bn)(\d+)\.(\w+)$", key)
            idx = vgg_index[int(m.group(2))] + (m.group(1) == "bn")
            leaf = "weight" if m.group(3) == "kernel" else _BN.get(m.group(3), m.group(3))
            state[f"features.{idx}.{leaf}"] = _oihw(value) if m.group(3) == "kernel" else value
            continue
        for pattern, target, layout in _RULES[family]:
            if re.match(pattern, key):
                out = re.sub(pattern, target, key).format(dc=1 if avg_down else 0,
                                                          db=2 if avg_down else 1)
                head, _, leaf = out.rpartition(".")
                if layout is None and leaf in _BN and family != "deit" and "se." not in out:
                    out = f"{head}.{_BN[leaf]}"
                state[out] = layout(value) if layout is not None else value
                break
        else:
            assert family == "deit" and key.startswith("head"), key
    return state


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "resnet26d", "seresnet50",
                                  "tf_efficientnet_lite0", "tf_efficientnet_b0",
                                  "deit_tiny_distilled_patch16_224", "vgg16", "vgg16_bn"])
def test_converters_match_jax(name):
    port, _ = preg.make_feature_network(name, generator=torch.Generator().manual_seed(1))
    state = torch_state(name, port)
    got = preg.convert_feature_network_state(name, state)
    want = jreg.convert_feature_network_state(name, state)
    flat_got = {c: _flat(t) for c, t in got.items()}
    flat_want = {c: _flat(jax.tree_util.tree_map(np.asarray, t)) for c, t in want.items()}
    assert flat_got.keys() == flat_want.keys()
    for coll in flat_got:
        assert flat_got[coll].keys() == flat_want[coll].keys(), coll
        for k, v in flat_want[coll].items():
            np.testing.assert_array_equal(flat_got[coll][k], v, err_msg=k)
    if "deit" in name:  # the trunk only: the heads keep the module's own init
        own = to_jax_variables(port)
        own["params"].update(got["params"])
        got = own
    load_jax_variables(port, got)
