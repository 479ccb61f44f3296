"""Parity of the port's progressive growth (`models/sg3/superres.py`), the
superres trainer and `train_setgan`'s pretrained loaders with the JAX
package's, on the CPU.

- `superres_config` and `head_layer_names` equal to JAX's, slim and at
  `train_setgan_superres.sh`'s recipe (an SG3-T 256 stem with channel base
  16384, max 256, 7 layers, grown ×2 with 4 head layers);
- `reinit_stem` on a slim tree equal to JAX's, leaf for leaf; at the
  recipe's widths (trees from `jax.eval_shape`) the 17 leaves it carries
  pinned: the layer names of the grown decoder differ from the stem's past
  L0, so L1–L4 keep their init (ROADMAP Queue 3, "Facts of the
  reference");
- the class embeddings (`class_embedding_init`, `load_class_embedding` on
  a pickled ``nn.Embedding``) and `load_encoder_variables` on a reference
  ReStyle ``.pt`` equal to JAX's, to 0.

The superres trainer's G step is held to JAX's in
`test_torch_superres_step.py`.
"""

import dataclasses
import importlib.util
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu.models.sg3 import config as jconfig
from stylegan3_editing_tpu.models.sg3 import superres as jsuper
from stylegan3_editing_tpu_torch.models.sg3 import SG3Config, sg3_t_config
from stylegan3_editing_tpu_torch.models.sg3 import superres

from test_torch_encoders import irse50_reference_state
from test_torch_setgan_train import SLIM, _flat, decoder_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RECIPE = dict(channel_base=16384, channel_max=256, num_layers=7)
STEM = {**SLIM, "img_resolution": 16}
# The 17 leaves `reinit_stem` carries at train_setgan_superres.sh's recipe.
RECIPE_CARRIED = sorted(
    [f"params/mapping/fc{i}/{k}" for i in (0, 1) for k in ("weight", "bias")]
    + ["ema/mapping/w_avg", "params/synthesis/input/weight", "params/synthesis/input/affine/weight",
       "params/synthesis/input/affine/bias", "buffers/synthesis/input/freqs",
       "buffers/synthesis/input/phases"]
    + [f"params/synthesis/L0_36_256/{k}" for k in ("weight", "bias", "affine/weight",
                                                   "affine/bias")]
    + ["buffers/synthesis/L0_36_256/up_filter", "buffers/synthesis/L0_36_256/down_filter",
       "ema/synthesis/L0_36_256/magnitude_ema"])


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("remat", None)  # an option of the JAX package alone
    return d


@pytest.mark.parametrize("stem,res,heads", [(STEM, 32, 2), ({**RECIPE, "img_resolution": 256},
                                                            512, 4)])
def test_superres_config_and_heads_match_jax(stem, res, heads):
    jstem_cfg, stem_cfg = JSG3Config(**stem), SG3Config(**stem)
    if "z_dim" not in stem:
        jstem_cfg = jconfig.sg3_t_config(256, **RECIPE)
        stem_cfg = sg3_t_config(256, **RECIPE)
    jgrown = jsuper.superres_config(jstem_cfg, res, heads)
    grown = superres.superres_config(stem_cfg, res, heads)
    assert _cfg_dict(grown) == _cfg_dict(jgrown)
    assert superres.head_layer_names(grown, stem_cfg) == jsuper.head_layer_names(jgrown,
                                                                                 jstem_cfg)
    if res == 512:  # the recipe: 11 filtered layers and ToRGB, the last 7 of them heads
        names = [s.name for s in jconfig.build_synthesis_layout(jgrown).layers]
        assert names[6:9] == ["L6_276_161", "L7_276_94", "L8_532_55"] and len(names) == 12
        assert superres.head_layer_names(grown, stem_cfg) == tuple(names[5:])


def test_reinit_stem_matches_jax_on_a_slim_tree():
    stem_cfg = JSG3Config(**STEM)
    grown_cfg = jsuper.superres_config(stem_cfg, 32, 2)
    stem_vars = jax.tree_util.tree_map(np.asarray, decoder_variables(stem_cfg, seed=11))
    grown_vars = jax.tree_util.tree_map(np.asarray, decoder_variables(grown_cfg, seed=12))
    want = jax.tree_util.tree_map(np.asarray, jsuper.reinit_stem(grown_vars, stem_vars))
    got = superres.reinit_stem(grown_vars, stem_vars)
    assert _flat(got).keys() == _flat(want).keys()
    for k, v in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[k], v, err_msg=k)
    carried = superres.matching_leaves(grown_vars, stem_vars)
    changed = [k for k, v in _flat(want).items() if not np.array_equal(v, _flat(grown_vars)[k])]
    assert set(changed) <= {k.replace("/", ".") for k in carried} and len(carried) >= 10
    assert _flat(grown_vars).keys() == _flat(got).keys()  # the input tree is left as it was


def test_reinit_stem_at_the_recipe_widths_carries_17_leaves():
    """The recipe's stem and grown trees (shapes only): the mapping, the
    input and L0 carry; L1–L4 (``L1_36_256`` here, ``L1_52_256`` in the
    stem) keep their fresh init, and under ``train_head_only`` stay frozen
    at it."""
    from stylegan3_editing_tpu.models.sg3 import Generator as JGen

    stem_cfg = jconfig.sg3_t_config(256, **RECIPE)
    grown_cfg = jsuper.superres_config(stem_cfg, 512, 4)
    z = jnp.zeros((1, 512))
    stem, grown = (jax.eval_shape(JGen(c).init, jax.random.PRNGKey(0), z)
                   for c in (stem_cfg, grown_cfg))
    carried = superres.matching_leaves(grown, stem)
    assert sorted(carried) == RECIPE_CARRIED and len(carried) == 17
    grown_layers = [s.name for s in jconfig.build_synthesis_layout(grown_cfg).layers]
    stem_layers = [s.name for s in jconfig.build_synthesis_layout(stem_cfg).layers]
    assert grown_layers[1:5] == ["L1_36_256", "L2_52_256", "L3_84_256", "L4_84_256"]
    assert not set(grown_layers[1:5]) & set(stem_layers)
    heads = jsuper.head_layer_names(grown_cfg, stem_cfg)
    assert not set(grown_layers[1:5]) & set(heads)


def test_class_embeddings_match_jax(tmp_path):
    np.testing.assert_array_equal(superres.class_embedding_init(7, 5, seed=3),
                                  jsuper.class_embedding_init(7, 5, seed=3))
    emb = torch.nn.Embedding(12, 4)
    with open(tmp_path / "emb.pkl", "wb") as f:
        pickle.dump({"embed": emb}, f)
    got = superres.load_class_embedding(tmp_path / "emb.pkl")
    assert got.dtype == np.float32 and got.shape == (12, 4)
    np.testing.assert_array_equal(got, jsuper.load_class_embedding(tmp_path / "emb.pkl"))
    np.testing.assert_array_equal(got, emb.weight.detach().numpy())


def test_load_encoder_variables_matches_jax(tmp_path, monkeypatch):
    """A full-model checkpoint's ``encoder.*`` keys (IR-SE-50, 2 styles)."""
    from stylegan3_editing_tpu_torch.scripts import train_setgan

    state = irse50_reference_state(2, seed=4)
    torch.save({"state_dict": {f"encoder.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in state.items()}, "opts": {"n_styles": 2}},
               tmp_path / "setgan.pt")
    spec = importlib.util.spec_from_file_location("jax_train_setgan",
                                                  ROOT / "scripts" / "train_setgan.py")
    jcli = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, jcli)  # its dataclasses look their module up
    spec.loader.exec_module(jcli)
    want = _flat(jax.tree_util.tree_map(np.asarray, jcli.load_encoder_variables(
        str(tmp_path / "setgan.pt"))))
    got = _flat(train_setgan.load_encoder_variables(str(tmp_path / "setgan.pt")))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_setgan_pools_references_to_the_encoder_resolution():
    """The superres recipe feeds 512² sets to a 256² encoder, on which the
    JAX package's encoder raises. The port's ``ref_resolution`` average-pools
    the references to the encoder's size first, a choice of the port's own
    (ROADMAP Queue 3). Held against the JAX SetGAN given the same sets
    pooled 2×2 in numpy, within `test_torch_setgan.IMAGE_TOL`; at the
    encoder's own size the option changes nothing."""
    from test_torch_setgan import RES, close, inputs, port_setgan, setgan_variables

    mode = "no_mean_center"
    model, variables = setgan_variables(mode)
    _, z, mask = inputs()
    rng = np.random.RandomState(30)
    big = np.tanh(rng.randn(*mask.shape, 2 * RES, 2 * RES, 3)).astype(np.float32)
    pooled = big.reshape(*mask.shape, RES, 2, RES, 2, 3).mean((3, 5))
    want = jax.jit(lambda v, x, z, m: model.apply(v, x, z, ref_mask=m))(
        variables, pooled, z, mask)
    port = port_setgan(mode, variables, ref_resolution=RES)
    args = (torch.from_numpy(z),)
    kw = dict(ref_mask=torch.from_numpy(mask))
    with torch.no_grad():
        got = port(torch.from_numpy(big), *args, **kw)
        same_size = port(torch.from_numpy(pooled), *args, **kw)
        port.ref_resolution = None
        plain = port(torch.from_numpy(pooled), *args, **kw)
    close(got, want, "512²-style sets pooled to the encoder")
    assert torch.equal(same_size, plain)
