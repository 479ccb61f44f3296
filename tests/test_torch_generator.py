"""Parity of the port's SG3 generator with the JAX package, on slim configs.

Both packages get the same weights: the JAX generator is initialised once
per config (`jax.jit(model.init)`), its zero-initialised leaves and EMAs are
set to seeded random values so every path is exercised, and
`load_jax_variables` copies the tree into the port. Images are held at atol
1e-4: fp32 convs and matmuls sum in another order in the two frameworks,
through 5 layers. StyleSpace entries are held at 1e-5 and EMAs at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.sg3 import Generator as JaxGenerator
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu_torch.models.sg3 import Generator, load_jax_variables
from stylegan3_editing_tpu_torch.models.sg3 import config as tcfg

torch.set_num_threads(1)

# Slim SG3-R keeps radial u=2, radial u=4 crop, separable, separable crop
# and ToRGB layers; slim SG3-T has 3x3 convs.
SLIM = dict(channel_base=1024, channel_max=32, num_layers=4, use_bf16=False)
IMAGE_ATOL = 1e-4


def _perturb(variables, seed):
    """Replace all-zero parameters and the EMAs with seeded random values."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        leaf = np.asarray(leaf)
        names = [getattr(p, "key", None) for p in path]
        if names[0] == "ema":
            return (np.abs(rng.randn(*leaf.shape)) + 0.5).astype(np.float32) \
                if names[-1] == "magnitude_ema" else \
                (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        if names[0] == "params" and not leaf.any():
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, variables)


@pytest.fixture(scope="module", params=["r", "t"])
def pair(request):
    preset = request.param
    jmodel = JaxGenerator(getattr(jcfg, f"sg3_{preset}_config")(32, **SLIM))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 512)))
    variables = _perturb(variables, seed=1)
    tmodel = Generator(getattr(tcfg, f"sg3_{preset}_config")(32, **SLIM), device="cpu")
    load_jax_variables(tmodel, variables)
    z = np.random.RandomState(2).randn(2, 512).astype(np.float32)
    return jmodel, variables, tmodel, z


def _check(got, ref, atol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    print(f"{what}: max abs error {err:.3g} (atol {atol})")
    assert np.asarray(got).shape == np.asarray(ref).shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


def test_image_from_z_truncated(pair):
    jmodel, variables, tmodel, z = pair
    ref = jmodel.apply(variables, jnp.asarray(z), truncation_psi=0.7)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(z), truncation_psi=0.7)
    assert got.dtype == torch.float32
    _check(got, ref, IMAGE_ATOL, "image")


def test_w2s_entries(pair):
    jmodel, variables, tmodel, z = pair
    ws = np.array(jmodel.apply(variables, jnp.asarray(z), method=JaxGenerator.map))
    ref = jmodel.apply(variables, jnp.asarray(ws), method=JaxGenerator.w2s)
    with torch.no_grad():
        np.testing.assert_allclose(tmodel.map(torch.from_numpy(z)).numpy(), ws,
                                   atol=1e-5, rtol=0)
        got = tmodel.w2s(torch.from_numpy(ws))
    assert set(got) == set(ref)
    for name in ref:
        _check(got[name], ref[name], 1e-5, f"w2s[{name}]")


def test_synthesize_from_all_s(pair):
    jmodel, variables, tmodel, z = pair
    ws = jmodel.apply(variables, jnp.asarray(z), method=JaxGenerator.map)
    all_s = {k: np.asarray(v) for k, v in
             jmodel.apply(variables, ws, method=JaxGenerator.w2s).items()}
    ref = jmodel.apply(variables, None, all_s=all_s, method=JaxGenerator.synthesize)
    with torch.no_grad():
        got = tmodel.synthesize(None, all_s={k: torch.from_numpy(v) for k, v in all_s.items()})
    _check(got, ref, IMAGE_ATOL, "synthesize(all_s)")


def test_user_transform(pair):
    jmodel, variables, tmodel, z = pair
    a, tx, ty = 0.3, 0.12, -0.07
    m = np.array([[np.cos(a), np.sin(a), tx], [-np.sin(a), np.cos(a), ty], [0, 0, 1]],
                 np.float32)
    ref = jmodel.apply(variables, jnp.asarray(z), transform=jnp.asarray(m))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(z), transform=torch.from_numpy(m))
    _check(got, ref, IMAGE_ATOL, "image with transform")


def test_bf16_policy_image_matches_jax():
    """The bf16 policy above one op: a slim SG3-R with ``use_bf16`` and
    ``num_fp16_res=1`` (L0 in fp32, L1–L4 in bf16), against the JAX
    generator on the CPU; both run each bf16 layer as a composition of bf16
    ops. The image passes 4 bf16 layers of about 8 roundings each (input
    cast, style scale, conv, demodulation, bias, up-FIR, activation,
    down-FIR), each within 2⁻⁹ of its value; as independent errors that is
    √32·2⁻⁹ ≈ 1.1 % of the signal per package, and the two packages round
    apart where their sums run in another order, so the tolerance is twice
    that, 2.2 % of max |ref|. bf16 visibly moves the port's image off its
    fp32 image (``force_fp32``)."""
    kw = dict(SLIM, use_bf16=True, num_fp16_res=1)
    jmodel = JaxGenerator(jcfg.sg3_r_config(32, **kw))
    variables = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 512))),
                         seed=1)
    tcfg_ = tcfg.sg3_r_config(32, **kw)
    assert [s.use_bf16 for s in tcfg.build_synthesis_layout(tcfg_).layers] == \
        [False, True, True, True, True]
    tmodel = Generator(tcfg_, device="cpu")
    load_jax_variables(tmodel, variables)
    z = np.random.RandomState(2).randn(2, 512).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(z), truncation_psi=0.7))
    with torch.no_grad():
        got, got32 = (tmodel(torch.from_numpy(z), truncation_psi=0.7, force_fp32=fp32).numpy()
                      for fp32 in (False, True))
    assert got.dtype == np.float32
    _check(got, ref, 2 * np.sqrt(32) * 2 ** -9 * float(np.abs(ref).max()), "bf16 image")
    assert np.abs(got - got32).max() > 10 * IMAGE_ATOL, "bf16 is not in effect"


def test_update_emas_step(pair):
    jmodel, variables, tmodel, z = pair
    ref_img, updated = jmodel.apply(variables, jnp.asarray(z), update_emas=True,
                                    mutable=["ema"])
    state = {k: v.clone() for k, v in tmodel.state_dict().items()}
    try:
        with torch.no_grad():
            got_img = tmodel(torch.from_numpy(z), update_emas=True)
        _check(got_img, ref_img, IMAGE_ATOL, "image with update_emas")
        ema = updated["ema"]
        _check(tmodel.mapping.w_avg, ema["mapping"]["w_avg"], 1e-6, "w_avg")
        for name in tmodel.synthesis.layer_names:
            _check(getattr(tmodel.synthesis, name).magnitude_ema,
                   ema["synthesis"][name]["magnitude_ema"], 1e-6, f"{name} magnitude_ema")
    finally:
        tmodel.load_state_dict(state)
