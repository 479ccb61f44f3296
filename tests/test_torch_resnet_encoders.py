"""Parity of the port's ResNet-34 ReStyle encoders with the JAX package's, on the CPU.

The JAX trees come from `jax.eval_shape` of the flax modules' init, every
leaf drawn from a numpy seed (`seeded_variables` of `test_torch_encoders.py`:
batch-norm statistics non-trivial, so no batch norm is the identity), and
`load_jax_variables` copies them into the port. Inputs are seeded numpy
arrays. Tolerances (fp32 on both sides; the convs sum in another order in
XLA and in PyTorch, about 1e-7 relative a sum), as in
`test_torch_encoders.py`:
- `BasicBlock` (two convs and batch norms): 1e-5 of max |ref|;
- `ResNet34Body` and the encoders (36 convs and batch norms deep, then a
  head of 4 convs): 1e-4 of max |ref|.
RestyleNet with each ResNet trunk is held in `test_torch_resnet_restyle.py`.
The converter's ResNet branch is held leaf for leaf against the JAX one on
a state dict with the reference's key names (the flat ``body.N`` of the
reference's Sequential).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.backbones import resnet as jresnet
from stylegan3_editing_tpu.models.encoders import backbones as jbackbones
from stylegan3_editing_tpu.models.encoders import convert as jconvert
from stylegan3_editing_tpu_torch.models.backbones import resnet
from stylegan3_editing_tpu_torch.models.encoders import (INFERENCE_STAGE, ResNetBackboneEncoder,
                                                         ResNetProgressiveBackboneEncoder,
                                                         convert_restyle_encoder_state)
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from test_torch_encoders import (ENCODER_TOL, LAYER_TOL, check, init_module, seeded,
                                 seeded_variables, t)

torch.set_num_threads(1)

ENCODERS = {"ResNetBackboneEncoder": (jbackbones.ResNetBackboneEncoder, ResNetBackboneEncoder),
            "ResNetProgressiveBackboneEncoder": (jbackbones.ResNetProgressiveBackboneEncoder,
                                                 ResNetProgressiveBackboneEncoder)}
STAGES = (0, 2, INFERENCE_STAGE)


@functools.lru_cache(maxsize=None)
def _shapes(n_styles):
    enc = jbackbones.ResNetBackboneEncoder(n_styles=n_styles)
    return jax.eval_shape(enc.init, jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 6)))


def resnet_encoder_variables(n_styles, seed):
    """Seeded variables of a 6-channel ResNet-34 ReStyle encoder, pSp or e4e."""
    return seeded_variables(_shapes(n_styles), seed)


@pytest.mark.parametrize("stride,downsample", [(1, False), (2, True)])
def test_basic_block_matches_jax(stride, downsample):
    channels = 64 if not downsample else 128
    x = seeded(2, 12, 10, 64, seed=70)
    jblock = jresnet.BasicBlock(channels, stride, downsample)
    v = init_module(jblock, x, seed=71)
    m = resnet.BasicBlock(64, channels, stride, downsample)
    load_jax_variables(m, v)
    with torch.no_grad():
        check(m(t(x)), jblock.apply(v, x), LAYER_TOL, f"BasicBlock stride {stride}")


def test_resnet34_body_matches_jax():
    """layer1-4 at 64²: stride 2 and the downsample on the first block of
    stages 2-4 only (16 blocks, 36 convs)."""
    x = seeded(1, 64, 64, 64, seed=72)
    jbody = jresnet.ResNet34Body()
    v = init_module(jbody, x, seed=73)
    m = resnet.ResNet34Body()
    load_jax_variables(m, v)
    assert [n for n, _ in m.named_children() if hasattr(getattr(m, n), "down_conv")] == \
        ["layer2_0", "layer3_0", "layer4_0"]
    with torch.no_grad():
        got = m(t(x))
    assert got.shape == (1, 8, 8, 512)
    check(got, jax.jit(jbody.apply)(v, x), ENCODER_TOL, "ResNet34Body")


@pytest.fixture(scope="module")
def encoders():
    """pSp and e4e with one seeded tree at 256², 6 channels, 3 styles, and
    the JAX package's codes (e4e at every stage of `STAGES`), each encoder's
    in one `jax.jit`."""
    x = seeded(1, 256, 256, 6, seed=74)
    v = resnet_encoder_variables(3, seed=75)
    out = {}
    for name, (jcls, tcls) in ENCODERS.items():
        jenc = jcls(n_styles=3)
        if "Progressive" in name:
            refs = jax.jit(lambda v, x: {s: jenc.apply(v, x, stage=s) for s in STAGES})(v, x)
        else:
            refs = dict.fromkeys(STAGES, jax.jit(jenc.apply)(v, x))
        m = tcls(n_styles=3, input_nc=6)
        load_jax_variables(m, v)
        out[name] = (m, refs)
    return x, out


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_resnet_encoder_matches_jax(encoders, name, stage):
    x, out = encoders
    m, refs = out[name]
    kwargs = {"stage": stage} if "Progressive" in name else {}
    with torch.no_grad():
        got = m(t(x), **kwargs)
    check(got, refs[stage], ENCODER_TOL, f"{name} stage {stage}")
    if kwargs and stage != INFERENCE_STAGE:
        rows = got[:, stage + 1:]
        assert torch.equal(rows, got[:, :1].expand_as(rows))


def resnet_reference_state(n_styles, seed=0, input_nc=6):
    """A state dict with the reference ResNet ReStyle encoder's key names and
    shapes (restyle_psp_encoders.ResNetBackboneEncoder: ``conv1``, ``bn1``,
    the PReLU ``relu``, layer1-4 flattened into ``body.N``), numpy only:
    convs normal with std 1/sqrt(fan_in), batch norms non-trivial with
    positive variances."""
    rng = np.random.default_rng(seed)
    state = {}

    def arr(*shape):
        z = rng.standard_normal(shape, dtype=np.float32)
        return z / float(np.sqrt(np.prod(shape[1:]))) if len(shape) == 4 else z

    def bn(prefix, c):
        state[f"{prefix}.weight"] = 1 + 0.1 * arr(c)
        state[f"{prefix}.bias"] = 0.1 * arr(c)
        state[f"{prefix}.running_mean"] = 0.1 * arr(c)
        state[f"{prefix}.running_var"] = 0.5 + np.abs(arr(c))
        state[f"{prefix}.num_batches_tracked"] = np.asarray(3)

    state["conv1.weight"] = arr(64, input_nc, 7, 7)
    bn("bn1", 64)
    state["relu.weight"] = 0.25 + 0.05 * arr(64)
    flat, in_c = 0, 64
    for stage_i, (blocks, c) in enumerate(resnet.RESNET34_LAYERS, start=1):
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


def test_convert_resnet_encoder_state_matches_jax():
    """The ResNet branch: the port's tree equals the JAX converter's leaf for
    leaf, also from torch tensors, and fills both port encoders name for name."""
    state = resnet_reference_state(n_styles=2, seed=76)
    got, info = convert_restyle_encoder_state(state)
    ref, ref_info = jconvert.convert_restyle_encoder_state(state)
    assert info == ref_info == {"trunk": "resnet34", "n_styles": 2}
    flat_got, flat_ref = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, ref))
    assert sorted(flat_got) == sorted(flat_ref)
    for k in flat_ref:
        assert flat_got[k].dtype == flat_ref[k].dtype, k
        np.testing.assert_array_equal(flat_got[k], flat_ref[k], err_msg=k)
    again, _ = convert_restyle_encoder_state({k: torch.from_numpy(np.asarray(v))
                                              for k, v in state.items()})
    assert all(np.array_equal(_flat(again)[k], flat_got[k]) for k in flat_got)
    for cls in (ResNetBackboneEncoder, ResNetProgressiveBackboneEncoder):
        m = cls(n_styles=2, input_nc=6)
        load_jax_variables(m, got)
        # body.7 follows stage 1's 3 blocks and stage 2's 4: layer3's first block.
        assert torch.equal(m.trunk.body.layer3_0.down_conv.kernel,
                           torch.from_numpy(state["body.7.downsample.0.weight"]
                                            .transpose(2, 3, 1, 0)))
        assert torch.equal(m.trunk.relu.alpha, torch.from_numpy(state["relu.weight"]))
