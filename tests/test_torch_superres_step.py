"""One superres G step of the port's `SetGANTrainer` against the JAX
trainer's, on the CPU.

A 16² stem (`test_torch_superres.STEM`: the slim trainer of
`test_torch_setgan_train`, fp32) grown to 32² with 2 head layers; the JAX
trainer built with its `jax.jit(init)` answered by seeded trees and its
stem merged by its own `reinit_stem`; the port's trainer merges the same
stem. Held: the leaves the port carries equal the JAX trainer's merged
ones; from one state (the JAX trainer's merged G and its D) the trainable
set (the head layers, the encoder and the style attention; not the
mapping nor the stem's layers), the G loss within `LOSS_TOL` = 1e-5 and
every gradient within `GRAD_TOL` = 1e-3 of its group's largest |entry|
(`test_torch_setgan_train.py`'s bounds). The JAX G step compiles once, at
XLA's backend optimisation level 0 (~45 s of the file's ~55).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu.models.sg3 import superres as jsuper
from stylegan3_editing_tpu.parallel import create_mesh
from stylegan3_editing_tpu.setgan import model as jmodel
from stylegan3_editing_tpu.setgan import training_loop as jtl
from stylegan3_editing_tpu.setgan.loss import SetGANLossConfig as JLossConfig
from stylegan3_editing_tpu_torch.models.sg3 import SG3Config, load_jax_variables
from stylegan3_editing_tpu_torch.models.sg3.from_jax import to_jax_variables
from stylegan3_editing_tpu_torch.setgan import SetGANTrainer

from test_torch_encoders import seeded_variables
from test_torch_feature_registry import seed_tree
from test_torch_setgan_disc import jax_draws
from test_torch_setgan_train import (B, C, CFG, LOSS, REF, RES, Z_DIM, _flat, batch_np,
                                     decoder_variables, port_config)
from test_torch_superres import STEM, _cfg_dict

torch.set_num_threads(1)

LOSS_TOL, GRAD_TOL = 1e-5, 1e-3


@functools.lru_cache(maxsize=None)
def grown_g_variables():
    """The JAX SetGAN's tree for the 32² decoder grown from `STEM` (fp32, as
    the stem: a grown config takes the bf16 policy's default otherwise):
    encoder and style attention seeded from numpy, the decoder from its own
    init."""
    grown = jsuper.superres_config(JSG3Config(**STEM), 32, 2, use_bf16=False)
    model = jmodel.SetGAN(grown, attn_layers=1, encoder_num_layers=8)
    shapes = jax.eval_shape(functools.partial(model.init, latent_avg=jnp.zeros(Z_DIM)),
                            jax.random.PRNGKey(0), jnp.zeros((1, 1, REF, REF, 3)),
                            jnp.zeros((1, 1, Z_DIM)))
    gen = jax.tree_util.tree_map(np.asarray, decoder_variables(grown, seed=13))
    enc = seeded_variables({"params": shapes["params"]["encoder"],
                            "batch_stats": shapes["batch_stats"]["encoder"]}, seed=14)
    attn = seeded_variables({"params": shapes["params"]["style_attn"]}, seed=15)["params"]
    return grown, {"params": {"encoder": enc["params"], "decoder": gen["params"],
                              "style_attn": attn},
                   "batch_stats": {"encoder": enc["batch_stats"]},
                   "buffers": {"decoder": gen["buffers"]}, "ema": {"decoder": gen["ema"]}}


def jax_superres_trainer(cfg_kw, grown, g_vars, stem_vars):
    """The JAX trainer with its `jax.jit(init)` answered by seeded trees and
    its G optimizer's gradients captured."""
    real_jit = jax.jit

    def jit(fn, *args, **kwargs):
        if getattr(fn, "__name__", None) == "init":
            owner = fn.__self__
            if isinstance(owner, jmodel.SetGAN):
                return lambda *a, **k: jax.tree_util.tree_map(jnp.asarray, g_vars)
            return lambda *a, **k: jax.tree_util.tree_map(
                jnp.asarray, seed_tree(jax.eval_shape(owner.init, *a, **k), seed=21))
        return real_jit(fn, *args, **kwargs)

    jax.jit = jit
    try:
        tr = jtl.SetGANTrainer(jtl.SetGANTrainConfig(**cfg_kw, loss=JLossConfig(**LOSS)), grown,
                               mesh=create_mesh(devices=jax.devices()[:1]),
                               stem_variables=stem_vars)
    finally:
        jax.jit = real_jit
    tr.captured = []
    tx = tr.g_tx

    def update(grads, state, params=None):
        jax.debug.callback(lambda g: tr.captured.append(jax.tree_util.tree_map(np.array, g)),
                           grads)
        return tx.update(grads, state, params)

    tr.g_tx = optax.GradientTransformation(tx.init, update)
    return tr


def test_superres_g_step_matches_jax():
    stem_cfg = JSG3Config(**STEM)
    grown, g_vars = grown_g_variables()
    heads = jsuper.head_layer_names(grown, stem_cfg)
    stem_vars = jax.tree_util.tree_map(np.asarray, decoder_variables(stem_cfg, seed=11))
    kw = dict(train_head_only=True, head_layer_names=heads)
    jt = jax_superres_trainer({**CFG, **kw}, grown, g_vars, stem_vars)
    port = SetGANTrainer(port_config(**kw), SG3Config(**_cfg_dict(grown)),
                         device="cpu", stem_variables=stem_vars)
    # The merge: the port carries what the JAX trainer carried, value for value.
    merged = _flat(jax.tree_util.tree_map(np.asarray, {
        c: jt.g_vars[c]["decoder"] for c in ("params", "buffers", "ema")}))
    port_tree = _flat(to_jax_variables(port.G.decoder))
    carried = port.carried["decoder"]
    assert len(carried) >= 10
    for path in carried:
        key = path.replace("/", ".")
        np.testing.assert_array_equal(port_tree[key], merged[key], err_msg=key)
    # One state for both: the JAX trainer's merged G and its D.
    for module in (port.G, port.G_ema):
        load_jax_variables(module, jax.tree_util.tree_map(np.asarray, jt.g_vars))
    load_jax_variables(port.D, {"params": jax.tree_util.tree_map(np.asarray,
                                                                 jt.d_vars["params"])})
    port.latent_avg = torch.from_numpy(np.array(jt.latent_avg))
    batch = batch_np(21)
    placed = dict(jt._place_batch(batch))
    placed.pop("_meta")
    z = np.random.RandomState(22).randn(B, C, Z_DIM).astype(np.float32)
    kg = jax.random.PRNGKey(23)
    step = jax.jit(jt._g_step_impl, static_argnames=("blur_sigma", "do_pl"))
    args = (jt.g_vars["params"], jt.g_opt, jt.d_vars["params"], placed, jnp.asarray(z), kg,
            jt.pl_mean, jnp.asarray(0.0, jnp.float32))
    compiled = step.lower(*args, blur_sigma=2.0, do_pl=False).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    _, _, jstats, _ = compiled(*args)
    want = {k.replace(".", "/"): v for k, v in _flat(jt.captured[-1]).items()}
    loss, _, got = port.g_loss_and_grads(port._place(batch), torch.from_numpy(z),
                                         {"g": jax_draws(kg, B * C, RES, RES)}, 2.0)
    assert abs(float(loss) - float(jstats["Loss/G/loss"])) <= LOSS_TOL * max(
        1.0, abs(float(jstats["Loss/G/loss"])))
    # The trainable set: the heads, the encoder and the style attention.
    trains = {n for n in got}
    assert all(n.split(".")[0] in ("encoder", "style_attn") or
               n.split(".")[2] in heads for n in trains)
    assert {n.split(".")[2] for n in trains if n.startswith("decoder.")} == set(heads)
    frozen_jax = {k for k, v in want.items() if not np.any(v)} - {
        n.replace(".", "/") for n in trains}
    assert not any(k.startswith(("encoder/", "style_attn/")) for k in frozen_jax
                   if not k.startswith("style_attn/attn_0/") and
                   not k.startswith("style_attn/style_concat_0/"))
    for group in ("decoder", "encoder", "style_attn"):
        names = [n for n in got if n.startswith(group + ".")]
        scale = max(float(np.abs(want[n.replace(".", "/")]).max()) for n in names)
        for n in names:
            err = float(np.abs(got[n].numpy() - want[n.replace(".", "/")]).max())
            assert err <= GRAD_TOL * scale, (n, err, scale)
