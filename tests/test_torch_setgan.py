"""Parity of the port's SetGAN generator with the JAX package's, on the CPU.

The model is `tests/test_setgan.py`'s slim decoder (`tiny_cfg`: 32², 4
layers of 32 channels, fp32) under the IR-SE encoder at
``encoder_num_layers=8``, with one attention layer a style. One tree serves
both packages: the JAX `SetGAN`'s shapes from `jax.eval_shape`, the encoder
and the style attention filled from a numpy seed
(`test_torch_encoders.seeded_variables`: kernels normal with std
1/sqrt(fan in), batch-norm statistics non-trivial, biases and LayerNorm
affines non-zero), the decoder from the JAX generator's own init with its
zero leaves and EMAs seeded (`generator_variables`). The JAX forward runs
under `jax.jit` (eagerly each op compiles alone). Reference sets are 64²
(the trunk's 4×4 map, which each head's stride-2 convs take to 1×1, as
they take a 256² image's 16×16) with a padded slot in one set.

Tolerance: images and latents within 2e-4 of max |ref|, RestyleNet's image
tolerance (`test_torch_encoders.py`): the 8-layer trunk's codes (1e-4 of
their scale) go through the style attention and 5 decoder layers.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu.setgan import model as jmodel
from stylegan3_editing_tpu_torch.models.sg3 import SG3Config, load_jax_variables
from stylegan3_editing_tpu_torch.models.sg3.from_jax import to_jax_variables
from stylegan3_editing_tpu_torch.setgan import SetGAN, make_stem, to_images, to_imgset, to_set

from test_torch_encoders import generator_variables, seeded_variables

torch.set_num_threads(1)

IMAGE_TOL = 2e-4
TINY = dict(img_resolution=32, channel_base=512, channel_max=32, num_layers=4, num_critical=2,
            use_bf16=False)  # tests/test_setgan.py's tiny_cfg
B, R, C = 2, 3, 2
RES = 64  # reference images: the trunk gives 4×4, each head pools it to 1×1
MODES = {"mean_center": dict(mean_center=True),
         "no_mean_center": dict(mean_center=False),
         "restyle_encoder": dict(mean_center=True, restyle_mode="encoder", restyle_iters=2)}


@functools.lru_cache(maxsize=None)
def _generator_variables():
    return generator_variables(JSG3Config(**TINY), seed=3)


@functools.lru_cache(maxsize=None)
def setgan_variables(mode):
    kw = MODES[mode]
    model = jmodel.SetGAN(JSG3Config(**TINY), attn_layers=1, encoder_num_layers=8, **kw)
    x = jnp.zeros((1, 1, 256, 256, 3))
    z = jnp.zeros((1, 1, 512))
    shapes = jax.eval_shape(functools.partial(model.init, latent_avg=jnp.zeros(512)),
                            jax.random.PRNGKey(0), x, z)
    gen = _generator_variables()
    enc = seeded_variables({"params": shapes["params"]["encoder"],
                            "batch_stats": shapes["batch_stats"]["encoder"]}, seed=4)
    rng = np.random.default_rng(5)
    attn = {}
    for name, sub in shapes["params"]["style_attn"].items():
        if name.startswith("style_concat"):  # [0.2 N | I] as the init, a bias
            d = sub["bias"].shape[0]
            attn[name] = {"weight": np.concatenate([0.2 * rng.standard_normal(
                (d, d), np.float32), np.eye(d, dtype=np.float32)], 1),
                "bias": 0.1 * rng.standard_normal(d, np.float32)}
        else:
            attn[name] = seeded_variables({"params": sub}, seed=6 + len(attn))["params"]
    variables = {"params": {"encoder": enc["params"], "decoder": gen["params"],
                            "style_attn": attn},
                 "batch_stats": {"encoder": enc["batch_stats"]},
                 "buffers": {"decoder": gen["buffers"]}, "ema": {"decoder": gen["ema"]}}
    return model, variables


def port_setgan(mode, variables, **extra):
    m = SetGAN(SG3Config(**TINY), attn_layers=1, encoder_num_layers=8, device="cpu",
               **MODES[mode], **extra)
    load_jax_variables(m, variables)
    return m.eval()


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = np.tanh(rng.randn(B, R, RES, RES, 3)).astype(np.float32)
    z = rng.randn(B, C, 512).astype(np.float32)
    mask = np.array([[True, True, False], [True, True, True]])
    return x, z, mask


def close(got, ref, what):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    err = float(np.abs(got - ref).max())
    print(f"{what}: max abs err {err:.3g}, max |ref| {np.abs(ref).max():.3g}")
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert err <= IMAGE_TOL * np.abs(ref).max(), what


@pytest.fixture(scope="module", params=list(MODES))
def runs(request):
    mode = request.param
    model, variables = setgan_variables(mode)
    x, z, mask = inputs()
    latent_avg = np.asarray(variables["ema"]["decoder"]["mapping"]["w_avg"])
    fwd = jax.jit(lambda v, x, z, m, la: model.apply(v, x, z, latent_avg=la, ref_mask=m,
                                                     return_latents=True))
    want = fwd(variables, x, z, mask, latent_avg)
    port = port_setgan(mode, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(z),
                   latent_avg=torch.from_numpy(latent_avg), ref_mask=torch.from_numpy(mask),
                   return_latents=True)
    return mode, variables, port, (x, z, mask, latent_avg), want, got


def test_setgan_matches_jax(runs):
    mode, _, _, _, (want_img, want_lat), (img, lat) = runs
    assert tuple(img.shape) == (B, C, 32, 32, 3)
    close(img, want_img, f"{mode} images")
    close(lat, want_lat, f"{mode} latents")


def test_setgan_images_only_and_input_code(runs):
    """Without ``return_latents`` the images alone; with ``input_code`` the
    mapped z given as W+ give the same images (the mapping skipped)."""
    mode, _, port, (x, z, mask, la), _, (img, lat) = runs
    args = dict(latent_avg=torch.from_numpy(la), ref_mask=torch.from_numpy(mask))
    with torch.no_grad():
        only = port(torch.from_numpy(x), torch.from_numpy(z), **args)
        torch.testing.assert_close(only, img, rtol=0, atol=0)
        if mode == "no_mean_center":
            ws = port.decoder.map(torch.from_numpy(z).reshape(-1, 512)).reshape(B, C, -1, 512)
            again = port(torch.from_numpy(x), ws, input_code=True, **args)
            torch.testing.assert_close(again, img, rtol=0, atol=0)


def test_setgan_state_round_trips(runs):
    """`to_jax_variables` writes the flax tree back leaf for leaf."""
    _, variables, port, _, _, _ = runs
    back = to_jax_variables(port)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}") if isinstance(v, dict)
                       else {f"{prefix}/{k}": np.asarray(v)})
        return out

    fa, fb = flat(back), flat(jax.tree_util.tree_map(np.asarray, variables))
    assert sorted(fa) == sorted(fb)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_setgan_remat_matches_no_remat():
    """The encoder recomputed in the backward: the same images and the same
    gradients as without."""
    _, variables = setgan_variables("mean_center")
    x, z, mask = inputs(1)
    la = torch.from_numpy(np.asarray(variables["ema"]["decoder"]["mapping"]["w_avg"]))
    out = {}
    for remat in (False, True):
        m = port_setgan("mean_center", variables, remat_encoder=remat)
        xt = torch.from_numpy(x[:1, :2]).requires_grad_(True)
        img = m(xt, torch.from_numpy(z[:1]), latent_avg=la, ref_mask=torch.from_numpy(mask[:1, :2]))
        grads = torch.autograd.grad(img.square().sum(), [xt] + [
            p for n, p in m.named_parameters() if n.startswith("encoder.style_0")])
        out[remat] = (img.detach(), grads)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


def test_setgan_padded_reference_changes_nothing():
    """Another image in a masked reference slot leaves every candidate as it
    was."""
    _, variables = setgan_variables("mean_center")
    port = port_setgan("mean_center", variables)
    x, z, mask = inputs(2)
    other = x.copy()
    other[0, 2] = np.tanh(np.random.RandomState(9).randn(RES, RES, 3))
    la = torch.from_numpy(np.asarray(variables["ema"]["decoder"]["mapping"]["w_avg"]))
    with torch.no_grad():
        a, b = (port(torch.from_numpy(v), torch.from_numpy(z), latent_avg=la,
                     ref_mask=torch.from_numpy(mask)) for v in (x, other))
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                               atol=1e-6 * float(a.abs().max()))


@pytest.mark.parametrize("stem", ["sg2", "fastgan"])
def test_other_stems_raise(stem):
    """The ``"sg2"`` and ``"fastgan"`` stems build and render through the
    encoder and the style attention (FastGAN: one W entry, no
    mean-centring, a zero ``latent_avg``); an unknown stem raises. Their
    parity with the JAX stems is in `test_torch_sg2_stem.py` and
    `test_torch_fastgan.py`."""
    from stylegan3_editing_tpu_torch.models.fastgan import FastGANGenerator
    from stylegan3_editing_tpu_torch.models.sg2_stem import SG2Generator

    decoder, n_ws = make_stem(stem, SG3Config(**TINY), device="cpu")
    assert isinstance(decoder, SG2Generator if stem == "sg2" else FastGANGenerator)
    assert n_ws == (8 if stem == "sg2" else 1)
    model = SetGAN(SG3Config(**TINY), stem=stem, attn_layers=1, encoder_num_layers=8,
                   mean_center=stem == "sg2", device="cpu").eval()
    x, z, mask = inputs(3)
    latent_avg = (model.decoder.mapping.w_avg if stem == "sg2"
                  else torch.zeros(TINY.get("w_dim", 512)))
    with torch.no_grad():
        imgs, lat = model(torch.from_numpy(x), torch.from_numpy(z), latent_avg=latent_avg,
                          ref_mask=torch.from_numpy(mask), return_latents=True)
    assert imgs.shape == (B, C, 32, 32, 3) and lat.shape == (B, C, n_ws, 512)
    assert torch.isfinite(imgs).all() and model.n_styles == n_ws
    with pytest.raises(ValueError):
        make_stem("nope", SG3Config(**TINY), device="cpu")


def test_set_reshapes():
    x = torch.arange(2 * 3 * 4).reshape(2, 3, 4)
    assert to_images(x).shape == (6, 4) and torch.equal(to_set(to_images(x), 2), x)
    assert torch.equal(to_imgset(lambda t: t * 2, x), 2 * x)
    assert dataclasses.is_dataclass(SG3Config(**TINY))
