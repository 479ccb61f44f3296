"""The registry's DenseNet, MobileNetV2, MNASNet, ShuffleNetV2, RegNetX/Y and CLIP
names against the JAX package's, on the CPU, without a compile.

Every one of the 25 names builds in the port with the JAX module's tree of
parameters and statistics (names and shapes, against `jax.eval_shape` of
its init; the port's built on the meta device, `to_jax_variables`' naming)
and its channels; `regnet_stages` (timm's width and group
adjustment) equals the JAX package's for all 16 RegNets.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan3_editing_tpu.models.backbones import registry as jreg
from stylegan3_editing_tpu.models.backbones import regnet as jregnet
from stylegan3_editing_tpu_torch.models.backbones import registry as preg
from stylegan3_editing_tpu_torch.models.backbones import regnet as pregnet

torch.set_num_threads(1)

SLICE_NAMES = sorted(n for n in jreg.available()
                     if n.startswith(("densenet", "mobilenet", "mnasnet", "shufflenet", "regnet",
                                      "clip_vit", "resnet50_clip")))


def _side(name):
    return 224 if name == "clip_vit_b32" else 64


def _shapes(tree):
    return {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_shapes(module):
    """``module``'s parameters and batch-norm statistics, by collection, as
    `to_jax_variables` names them (``['a']['b']``), with their shapes."""
    params = {n for n, _ in module.named_parameters()}
    out = {}
    for name, value in module.state_dict().items():
        coll = "params" if name in params else "batch_stats"
        out.setdefault(coll, {})["".join(f"['{k}']" for k in name.split("."))] = \
            tuple(value.shape)
    return out


@pytest.mark.parametrize("name", SLICE_NAMES)
def test_trees_match_jax(name):
    """Every name builds in the port (on the meta device: shapes only), with
    the JAX module's names and shapes."""
    jmod, _ = jreg.make_feature_network(name)
    side = _side(name)
    want = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)))
    with torch.device("meta"):
        port, spec = preg.make_feature_network(name)
    got = _port_shapes(port)
    assert got.keys() == want.keys()
    for coll in got:
        assert got[coll] == _shapes(want[coll]), coll
    assert spec.channels == tuple(jreg.get_spec(name).channels)


def test_slice_has_25_names():
    assert len(SLICE_NAMES) == 25 and len(pregnet.REGNET_PARAMS) == 16


@pytest.mark.parametrize("name", sorted(jregnet.REGNET_PARAMS))
def test_regnet_stages_match_jax(name):
    assert pregnet.regnet_stages(name) == jregnet.regnet_stages(name)
    assert preg.get_spec(name).channels == tuple(w for _, w, _ in jregnet.regnet_stages(name))
