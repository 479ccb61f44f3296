"""Parity of the port's rosinality StyleGAN2 (`models/stylegan2.py`) with the
JAX package's, on the CPU: the generator (single z, style mixing, W+
input, truncation, each noise mode) and the residual discriminator with
minibatch stddev.

The JAX modules' own inits give the weights, the zero leaves (biases,
noise weights) seeded from numpy; 32² images, style width 64, 2 mapping
layers. Random noise is passed to both packages as explicit maps.

Tolerance: 1e-5 of max |ref| (fp32 sum order of XLA's and oneDNN's
convolutions and FIR passes).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models import stylegan2 as jsg2
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from stylegan3_editing_tpu_torch.models.stylegan2 import SG2Discriminator, SG2Generator

torch.set_num_threads(1)

TOL = 1e-5
G_KW = dict(size=32, style_dim=64, n_mlp=2)


def _seeded(variables, seed):
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        leaf, names = np.asarray(leaf), [p.key for p in path]
        if names[-1] in ("bias", "activate_bias", "conv2_bias") or names[-2:] == ["noise",
                                                                                  "weight"]:
            return np.asarray(leaf + rng.randn(*leaf.shape) * 0.3, np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, jax.tree_util.tree_map(np.asarray,
                                                                         dict(variables)))


@functools.lru_cache(maxsize=None)
def generator_variables():
    z = jnp.zeros((1, 64))
    return _seeded(jax.jit(jsg2.SG2Generator(**G_KW).init)(jax.random.PRNGKey(0), z), 1)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("mode", ["single", "mixing", "latent_truncated", "const_noise"])
def test_sg2_generator_matches_jax(mode):
    variables = generator_variables()
    jg = jsg2.SG2Generator(**G_KW)
    port = SG2Generator(**G_KW, device="cpu")
    load_jax_variables(port, {"params": variables["params"]})
    rng = np.random.RandomState(2)
    z1, z2 = (rng.randn(2, 64).astype(np.float32) for _ in range(2))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    if mode == "const_noise":
        noises = {f"noise_{i}": rng.randn(1, r, r, 1).astype(np.float32)
                  for i, r in enumerate([4, 8, 8, 16, 16, 32, 32])}
        want = jg.apply({**variables, "noises": noises}, jnp.asarray(z1), noise_mode="const")
        for k, v in noises.items():
            getattr(port.noises, k).copy_(t(v))
        with torch.no_grad():
            got = port(t(z1), noise_mode="const")
        _close(got, want)
        return
    sizes = [4, 8, 8, 16, 16, 32, 32]
    noise = [rng.randn(2, r, r, 1).astype(np.float32) for r in sizes]
    # The JAX generator takes its noise maps through the "const" registry.
    jnoise = {"noises": {f"noise_{i}": n for i, n in enumerate(noise)}}
    kw, pkw = {}, {}
    if mode == "single":
        args = (jnp.asarray(z1),)
        pargs = (t(z1),)
    elif mode == "mixing":
        args, pargs = ([jnp.asarray(z1), jnp.asarray(z2)],), ([t(z1), t(z2)],)
        kw = pkw = dict(inject_index=3)
    else:
        w_avg = rng.randn(64).astype(np.float32)
        w = np.asarray(jg.apply(variables, jnp.asarray(z1), method=jg.mapping))
        args, pargs = (jnp.asarray(w),), (t(w),)
        kw = dict(input_is_latent=True, truncation=0.7, truncation_latent=jnp.asarray(w_avg))
        pkw = dict(input_is_latent=True, truncation=0.7, truncation_latent=t(w_avg))
    want, want_lat = jg.apply({**variables, **jnoise}, *args, noise_mode="const",
                              return_latents=True, **kw)
    with torch.no_grad():
        got, lat = port(*pargs, noise=[t(n) for n in noise], return_latents=True, **pkw)
    assert got.shape == (2, 32, 32, 3) and lat.shape == (2, port.n_latent, 64)
    _close(lat, want_lat)
    _close(got, want)


def test_sg2_generator_noise_modes():
    """'none' and 'random' without a generator add no noise; 'random' with
    one adds it; W+ ``styles`` bypass the mapping."""
    port = SG2Generator(**G_KW, device="cpu")
    with torch.no_grad():
        for n, p in port.named_parameters():
            if n.endswith("noise.weight"):
                p.fill_(0.5)
        z = torch.randn(2, 64, generator=torch.Generator().manual_seed(3))
        a = port(z, noise_mode="none")
        assert torch.equal(a, port(z)) and torch.equal(a, port(z, noise_mode="const"))
        assert not torch.equal(a, port(z, generator=torch.Generator().manual_seed(4)))
        _, lat = port(z, noise_mode="none", return_latents=True)
        assert torch.equal(port(styles=lat, noise_mode="none"), a)


def test_sg2_discriminator_matches_jax():
    img = np.tanh(np.random.RandomState(8).randn(8, 32, 32, 3)).astype(np.float32)
    jd = jsg2.SG2Discriminator(size=32, channel_multiplier=1)
    variables = _seeded(jax.jit(jd.init)(jax.random.PRNGKey(1), jnp.asarray(img)), 2)
    want = jd.apply(variables, jnp.asarray(img))
    port = SG2Discriminator(size=32, channel_multiplier=1, device="cpu")
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    assert got.shape == (8, 1)
    _close(got, want)
