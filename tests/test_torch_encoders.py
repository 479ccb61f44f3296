"""Parity of the port's IR-SE backbones, ReStyle encoders and RestyleNet with
the JAX package, on the CPU.

Both packages get the same weights. Each JAX tree comes from the JAX
package: the encoders' from `jax.eval_shape` of their flax `init` (flax's
own init of an IR trunk takes 8–20 s to compile on the CPU), every leaf
drawn from a numpy seed (`seeded_variables`: kernels normal with std
1/sqrt(fan_in), batch-norm statistics non-trivial, so no batch norm is the
identity); the decoder's from the JAX `Generator.init`, its zero leaves and
EMAs then drawn from a seed too. `load_jax_variables` copies each tree into
the port. Inputs are seeded numpy arrays.

Tolerances (fp32 on both sides; the convs sum in another order in XLA and
in PyTorch, about 1e-7 relative a sum):
- single layers (PReLU, BatchNorm, SEModule, BottleneckIR, a style head):
  1e-5 of max |ref|;
- trunks and encoders (8-layer IR-SE at 112² and 256², 13 convs and 12
  batch norms deep, then a head of 4 convs): 1e-4 of max |ref|;
- RestyleNet images on the 64² SG3 decoder and the codes of a second
  iteration (the codes go through 5 more layers and a 256² pool): 2e-4 of
  max |ref|, the generator tests' 1e-4 image tolerance on top of the
  codes' own error.
RestyleNet runs its encoders on the 8-layer trunk in both packages (each
package's encoder class with ``num_layers=8``; `test_torch_irse50.py` holds
both encoders at IR-SE-50's full depth). The IR-SE-50 tree itself is
checked key by key through `convert_restyle_encoder_state`.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.backbones import common as jcommon
from stylegan3_editing_tpu.models.backbones import irse as jirse
from stylegan3_editing_tpu.models.encoders import backbones as jbackbones
from stylegan3_editing_tpu.models.encoders import convert as jconvert
from stylegan3_editing_tpu.models.encoders import restyle as jrestyle
from stylegan3_editing_tpu.models.encoders.map2style import GradualStyleBlock as JGradualStyleBlock
from stylegan3_editing_tpu.models.sg3 import Generator as JaxGenerator
from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu_torch.models.backbones import common, irse
from stylegan3_editing_tpu_torch.models.encoders import (INFERENCE_STAGE, BackboneEncoder,
                                                         GradualStyleBlock,
                                                         ProgressiveBackboneEncoder, RestyleNet,
                                                         convert_restyle_encoder_state,
                                                         encoder_state_from_model_checkpoint,
                                                         get_average_image,
                                                         run_restyle_iterations)
from stylegan3_editing_tpu_torch.models.encoders import restyle as trestyle
from stylegan3_editing_tpu_torch.models.sg3 import SG3Config, load_jax_variables

LAYER_TOL = 1e-5
ENCODER_TOL = 1e-4
IMAGE_ATOL = 2e-4
TINY = dict(img_resolution=64, channel_base=1024, channel_max=64, num_layers=4,
            num_critical=2, use_bf16=False)  # tests/test_encoders.py's tiny decoder
ENCODERS = {"BackboneEncoder": (jbackbones.BackboneEncoder, BackboneEncoder),
            "ProgressiveBackboneEncoder": (jbackbones.ProgressiveBackboneEncoder,
                                           ProgressiveBackboneEncoder)}


# ------------------------------------------------------------------ helpers

def seeded_variables(shapes, seed):
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
        elif last == "alpha":
            v = 0.25 + 0.05 * z
        elif last == "bias":
            v = 0.1 * z
        elif last == "weight":  # FullyConnected, equalized LR: unit normal
            v = z
        else:
            raise KeyError(f"no rule for {names}")
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def init_module(module, *args, seed=0, **kwargs):
    """Seeded variables for a flax module from its init's shapes (no compile)."""
    shapes = jax.eval_shape(functools.partial(module.init, **kwargs),
                            jax.random.PRNGKey(0), *args)
    return seeded_variables(shapes, seed)


@functools.lru_cache(maxsize=None)
def _encoder_shapes(num_layers, n_styles):
    # pSp and e4e share one tree (every e4e head exists whatever the stage).
    enc = jbackbones.BackboneEncoder(num_layers=num_layers, n_styles=n_styles)
    return jax.eval_shape(enc.init, jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 6)))


def encoder_variables(num_layers, n_styles, seed):
    """Seeded variables of a 6-channel ReStyle encoder, pSp or e4e."""
    return seeded_variables(_encoder_shapes(num_layers, n_styles), seed)


def generator_variables(cfg, seed):
    """The JAX generator's own init, then its zero leaves and EMAs seeded."""
    variables = jax.jit(JaxGenerator(cfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 512)))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        leaf = np.asarray(leaf)
        names = [p.key for p in path]
        if names[0] == "ema":
            return (np.abs(rng.randn(*leaf.shape)) + 0.5).astype(np.float32) \
                if names[-1] == "magnitude_ema" else (rng.randn(*leaf.shape) * 0.1).astype(
                    np.float32)
        if names[0] == "params" and not leaf.any():
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, variables)


def restyle_variables(jax_cfg, n_styles, num_layers, seed):
    """A JAX RestyleNet tree (pSp or e4e) for the decoder config ``jax_cfg``
    (the JAX package's): a seeded encoder of ``num_layers`` and the
    generator's variables under ``decoder``."""
    ev = encoder_variables(num_layers, n_styles, seed)
    gv = generator_variables(jax_cfg, seed + 1)
    return {"params": {"encoder": ev["params"], "decoder": gv["params"]},
            "batch_stats": {"encoder": ev["batch_stats"]},
            "buffers": {"decoder": gv["buffers"]}, "ema": {"decoder": gv["ema"]}}


def port_restyle(cfg, encoder_type, n_styles, num_layers, variables):
    """The port's RestyleNet with its encoder class on ``num_layers``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(trestyle.ENCODER_TYPES, encoder_type,
                   functools.partial(ENCODERS[encoder_type][1], num_layers=num_layers))
        model = RestyleNet(SG3Config(**cfg), encoder_type, n_styles=n_styles, device="cpu")
    load_jax_variables(model, variables)
    return model


def jax_restyle(cfg, encoder_type, n_styles, num_layers):
    """The JAX RestyleNet, its encoder class on ``num_layers``."""
    enc_cls = functools.partial(ENCODERS[encoder_type][0], num_layers=num_layers)

    class Restyle(jrestyle.RestyleNet):
        def setup(self):
            self.encoder = enc_cls(n_styles=self.n_styles)
            self.decoder = JaxGenerator(self.decoder_cfg)

    return Restyle(decoder_cfg=JSG3Config(**cfg), encoder_type=encoder_type,
                   n_styles=n_styles)


def check(got, ref, tol, what, absolute=False):
    """max |got − ref| ≤ tol · max |ref| (or ≤ tol with ``absolute``)."""
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    scale = 1.0 if absolute else float(np.abs(ref).max())
    print(f"{what}: max abs err {err:.3g}, max |ref| {float(np.abs(ref).max()):.3g} "
          f"(tol {tol * scale:.3g})")
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert err <= tol * scale, what


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def seeded(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------ single layers

def test_prelu_matches_jax():
    x = seeded(2, 5, 6, 7)
    v = init_module(jcommon.PReLU(), x, seed=1)
    m = common.PReLU(7)
    load_jax_variables(m, v)
    with torch.no_grad():
        check(m(t(x)), jcommon.PReLU().apply(v, x), LAYER_TOL, "PReLU")


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_matches_jax(train):
    """Eval mode with running statistics, and train mode: the output from
    the batch's statistics and the updated running mean and variance."""
    x = seeded(3, 5, 6, 8, seed=2) * 2 + 0.5
    jbn = jcommon.BatchNorm()
    v = init_module(jbn, x, seed=3)
    m = common.BatchNorm(8)
    load_jax_variables(m, v)
    if train:
        ref, upd = jbn.apply(v, x, train=True, mutable=["batch_stats"])
        got = m(t(x), train=True)
        for k in ("mean", "var"):
            check(getattr(m, k), upd["batch_stats"][k], LAYER_TOL, f"BatchNorm running {k}")
        assert not np.allclose(m.mean.numpy(), v["batch_stats"]["mean"])
    else:
        ref, got = jbn.apply(v, x), m(t(x))
    check(got.detach(), ref, LAYER_TOL, f"BatchNorm train={train}")


def test_se_module_matches_jax():
    x = seeded(2, 6, 6, 64, seed=4)
    v = init_module(jirse.SEModule(), x, seed=5)
    m = irse.SEModule(64)
    load_jax_variables(m, v)
    with torch.no_grad():
        check(m(t(x)), jirse.SEModule().apply(v, x), LAYER_TOL, "SEModule")


@pytest.mark.parametrize("spec", [irse.BlockSpec(64, 64, 2), irse.BlockSpec(64, 128, 2),
                                  irse.BlockSpec(128, 128, 1)],
                         ids=["strided-view", "conv-shortcut", "identity"])
@pytest.mark.parametrize("use_se", [True, False])
def test_bottleneck_ir_matches_jax(spec, use_se):
    """The shortcut as a strided view (``in == depth``) and as a 1×1 conv + BN."""
    x = seeded(2, 10, 10, spec.in_channel, seed=6)
    jspec = jirse.BlockSpec(spec.in_channel, spec.depth, spec.stride)
    jblock = jirse.BottleneckIR(jspec, use_se)
    v = init_module(jblock, x, seed=7)
    m = irse.BottleneckIR(spec, use_se)
    load_jax_variables(m, v)
    with torch.no_grad():
        check(m(t(x)), jblock.apply(v, x), LAYER_TOL, f"BottleneckIR {spec} se={use_se}")


def test_gradual_style_block_matches_jax():
    x = seeded(2, 16, 16, 64, seed=8)
    jblock = JGradualStyleBlock(out_c=64, spatial=16)
    v = init_module(jblock, x, seed=9)
    m = GradualStyleBlock(64, 16)
    load_jax_variables(m, v)
    with torch.no_grad():
        check(m(t(x)), jax.jit(jblock.apply)(v, x), LAYER_TOL, "GradualStyleBlock")


def test_irse_backbone_matches_jax():
    """The 8-layer IR-SE face net at 112²: embeddings before and after the
    l2 norm agree."""
    x = seeded(2, 112, 112, 3, seed=10)
    jnet = jirse.IRSEBackbone(num_layers=8)
    v = init_module(jnet, x, seed=11)
    m = irse.IRSEBackbone(num_layers=8)
    load_jax_variables(m, v)
    with torch.no_grad():
        check(m(t(x)), jax.jit(jnet.apply)(v, x), ENCODER_TOL, "IRSEBackbone 8 layers")


# ------------------------------------------------------------------ encoders

STAGES = (0, 2, INFERENCE_STAGE)


@pytest.fixture(scope="module")
def encoders():
    """pSp and e4e on the 8-layer trunk with one seeded tree, and the JAX
    package's codes for a seeded 6-channel batch (e4e at every stage of
    `STAGES`), each encoder's in one `jax.jit`."""
    x = seeded(1, 256, 256, 6, seed=12)
    v = encoder_variables(8, 6, seed=13)
    out = {}
    for name, (jcls, tcls) in ENCODERS.items():
        jenc = jcls(num_layers=8, n_styles=6)
        if name == "ProgressiveBackboneEncoder":
            refs = jax.jit(lambda v, x: {s: jenc.apply(v, x, stage=s) for s in STAGES})(v, x)
        else:
            refs = dict.fromkeys(STAGES, jax.jit(jenc.apply)(v, x))
        m = tcls(num_layers=8, n_styles=6, input_nc=6)
        load_jax_variables(m, v)
        out[name] = (m, refs)
    return x, out


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_matches_jax(encoders, name, stage):
    """pSp and e4e on the 8-layer trunk at 256², ``n_styles=6``; e4e at
    stages 0 and 2 keeps w0 in the rows past the stage (pSp has no stages:
    its codes are checked once a stage)."""
    x, out = encoders
    m, refs = out[name]
    kwargs = {"stage": stage} if name == "ProgressiveBackboneEncoder" else {}
    with torch.no_grad():
        got = m(t(x), **kwargs)
    check(got, refs[stage], ENCODER_TOL, f"{name} stage {stage}")
    if kwargs and stage != INFERENCE_STAGE:
        rows = got[:, stage + 1:]
        assert torch.equal(rows, got[:, :1].expand_as(rows))


# --------------------------------------------------------------- RestyleNet

@pytest.fixture(scope="module")
def restyle():
    """The e4e RestyleNet in both packages, and each package's average
    image and 2-iteration inversion (with a landmarks transform, so every
    decode is the dual one) of a seeded face, the JAX package's each in one
    `jax.jit`."""
    n_styles = SG3Config(**TINY).num_ws
    v = restyle_variables(JSG3Config(**TINY), n_styles, 8, seed=20)
    jmodel = jax_restyle(TINY, "ProgressiveBackboneEncoder", n_styles, 8)
    tmodel = port_restyle(TINY, "ProgressiveBackboneEncoder", n_styles, 8, v)
    x = seeded(1, 256, 256, 3, seed=25)
    lt = np.eye(3, dtype=np.float32)
    lt[1, 2] = -0.08
    javg, jlat = jax.jit(functools.partial(jrestyle.get_average_image, jmodel))(v)
    ref = jax.jit(functools.partial(jrestyle.run_restyle_iterations, jmodel, n_iters=2))(
        v, x, javg, jlat, landmarks_transform=lt)
    with torch.no_grad():
        avg, lat = get_average_image(tmodel)
        got = run_restyle_iterations(tmodel, t(x), avg, lat, n_iters=2,
                                     landmarks_transform=t(lt))
    return tmodel, lt, (avg, lat, got), (javg, jlat, ref)


def test_restyle_encode_residual(restyle):
    """The first iteration adds ``latent_avg`` to the encoder's output, a
    later one the previous latent (the JAX package's residual logic; its
    codes are held against JAX through the iterations below)."""
    tmodel = restyle[0]
    x = seeded(1, 256, 256, 6, seed=21)
    avg, prev = seeded(512, seed=22), seeded(1, tmodel.n_styles, 512, seed=23)
    with torch.no_grad():
        first = tmodel.encode(t(x), latent_avg=t(avg))
        later = tmodel.encode(t(x), latent=t(prev), latent_avg=t(avg))
    np.testing.assert_allclose((later - first).numpy(), np.broadcast_to(prev - avg, first.shape),
                               atol=1e-5, rtol=0)


def test_restyle_dual_decode_matches_single_decode(restyle):
    """One batched decode over [identity; landmarks] gives the single
    decode's images in its identity half."""
    tmodel, lt, _, _ = restyle
    codes = seeded(2, tmodel.n_styles, 512, seed=24) * 0.5
    with torch.no_grad():
        single, none = tmodel.decode(t(codes))
        aligned, unaligned = tmodel.decode(t(codes), landmarks_transform=t(lt))
    assert none is None and single.shape == unaligned.shape == (2, 256, 256, 3)
    check(aligned, single, 1e-5, "dual decode aligned half vs single decode")
    assert not np.allclose(aligned.numpy(), unaligned.numpy(), atol=1e-3)


def test_restyle_average_image_matches_jax(restyle):
    _, _, (avg, lat, _), (javg, jlat, _) = restyle
    assert avg.shape == (256, 256, 3)
    np.testing.assert_array_equal(lat.numpy(), np.asarray(jlat))
    check(avg, javg, IMAGE_ATOL, "average image", absolute=True)


@pytest.mark.parametrize("step", [0, 1])
def test_run_restyle_iterations_matches_jax(restyle, step):
    """Two iterations from the average image with a landmarks transform:
    each iteration's codes and its aligned and unaligned images."""
    _, _, (_, _, got), (_, _, ref) = restyle
    assert len(got) == len(ref) == 2
    (a, u, c), (ra, ru, rc) = got[step], ref[step]
    check(c, rc, ENCODER_TOL, f"iteration {step} codes")
    check(a, ra, IMAGE_ATOL, f"iteration {step} aligned image", absolute=True)
    check(u, ru, IMAGE_ATOL, f"iteration {step} unaligned image", absolute=True)
    assert not np.allclose(got[0][2].numpy(), got[1][2].numpy())


def test_restyle_psp_encodes_without_stages():
    """The pSp RestyleNet runs the plain encoder (the e4e one above takes
    the stage); its encoder is held against JAX in `test_encoder_matches_jax`."""
    n_styles = SG3Config(**TINY).num_ws
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(trestyle.ENCODER_TYPES, "BackboneEncoder",
                   functools.partial(BackboneEncoder, num_layers=8))
        model = RestyleNet(SG3Config(**TINY), "BackboneEncoder", n_styles=n_styles,
                           device="cpu")
    assert not model.is_progressive and isinstance(model.encoder, BackboneEncoder)
    x = torch.from_numpy(seeded(1, 256, 256, 6, seed=31))
    with torch.no_grad():
        codes = model.encode(x, latent_avg=model.decoder.mapping.w_avg)
        assert torch.equal(codes, model.encoder(x) + model.decoder.mapping.w_avg)


# ----------------------------------------------------------------- converter

def irse50_reference_state(n_styles, seed=0):
    """A state dict with the reference ReStyle-e4e IR-SE-50 encoder's key
    names and shapes (restyle_e4e_encoders.ProgressiveBackboneEncoder),
    numpy only."""
    rng = np.random.default_rng(seed)
    state = {}

    def arr(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    def bn(prefix, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            state[f"{prefix}.{k}"] = arr(c)
        state[f"{prefix}.num_batches_tracked"] = np.asarray(7)

    state["input_layer.0.weight"] = arr(64, 6, 3, 3)
    bn("input_layer.1", 64)
    state["input_layer.2.weight"] = arr(64)
    for idx, spec in enumerate(s for st in irse.get_blocks(50) for s in st):
        p = f"body.{idx}"
        if spec.in_channel != spec.depth:
            state[f"{p}.shortcut_layer.0.weight"] = arr(spec.depth, spec.in_channel, 1, 1)
            bn(f"{p}.shortcut_layer.1", spec.depth)
        bn(f"{p}.res_layer.0", spec.in_channel)
        state[f"{p}.res_layer.1.weight"] = arr(spec.depth, spec.in_channel, 3, 3)
        state[f"{p}.res_layer.2.weight"] = arr(spec.depth)
        state[f"{p}.res_layer.3.weight"] = arr(spec.depth, spec.depth, 3, 3)
        bn(f"{p}.res_layer.4", spec.depth)
        state[f"{p}.res_layer.5.fc1.weight"] = arr(spec.depth // 16, spec.depth, 1, 1)
        state[f"{p}.res_layer.5.fc2.weight"] = arr(spec.depth, spec.depth // 16, 1, 1)
    for j in range(n_styles):
        for k in range(4):
            state[f"styles.{j}.convs.{2 * k}.weight"] = arr(512, 512, 3, 3)
            state[f"styles.{j}.convs.{2 * k}.bias"] = arr(512)
        state[f"styles.{j}.linear.weight"] = arr(512, 512)
        state[f"styles.{j}.linear.bias"] = arr(512)
    return state


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def test_convert_restyle_encoder_state_matches_jax():
    """An IR-SE-50 state dict with the reference's key names: the port's
    tree equals the JAX converter's leaf for leaf, and fills the port's
    e4e encoder, name for name, also from torch tensors and from a
    full-model checkpoint's ``encoder.*`` keys."""
    state = irse50_reference_state(n_styles=1)
    got, info = convert_restyle_encoder_state(state)
    ref, ref_info = jconvert.convert_restyle_encoder_state(state)
    assert info == ref_info == {"trunk": "irse", "num_layers": 50, "mode": "ir_se",
                                "n_styles": 1}
    flat_got, flat_ref = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, ref))
    assert sorted(flat_got) == sorted(flat_ref)
    for k in flat_ref:
        assert flat_got[k].dtype == flat_ref[k].dtype and np.array_equal(flat_got[k],
                                                                         flat_ref[k]), k
    ckpt = {"state_dict": {f"encoder.{k}": torch.from_numpy(np.asarray(v))
                           for k, v in state.items()}}
    sliced = encoder_state_from_model_checkpoint(ckpt)
    again, _ = convert_restyle_encoder_state(sliced)
    assert all(np.array_equal(_flat(again)[k], flat_got[k]) for k in flat_got)
    m = ProgressiveBackboneEncoder(num_layers=50, n_styles=1, input_nc=6)
    load_jax_variables(m, got)
    assert torch.equal(m.trunk.body_23.se.fc2.kernel,
                       torch.from_numpy(state["body.23.res_layer.5.fc2.weight"]
                                        .transpose(2, 3, 1, 0)))
