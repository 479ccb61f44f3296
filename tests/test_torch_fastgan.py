"""Parity of the port's SetGAN ``"fastgan"`` stem (`models/fastgan.py`) with
the JAX package's, on the CPU.

The JAX `FastGANGenerator`'s own init gives the weights, its zero leaves
(noise strengths, biases) and GroupNorm affines seeded from numpy; the
JAX package draws each conv's noise from ``fold_in(fold_in(rng, res),
idx)``, which the test draws too and passes to the port with every noise
strength non-zero. 64² images, so one skip-layer excitation (``se_64``,
from the 4² features) runs.

Tolerance: 1e-5 of max |ref| (fp32 sum order of the convs and the group
norms' E[x²] − E[x]²); the lite variant the same.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models import fastgan as jfast
from stylegan3_editing_tpu_torch.models.fastgan import FastGANConfig, FastGANGenerator
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables

torch.set_num_threads(1)

TOL = 1e-5


def _call(m, z, rng):
    return m.synthesize(m.map(z), rng=rng)


@functools.lru_cache(maxsize=None)
def jax_variables(lite: bool, res: int):
    cfg = jfast.FastGANConfig(z_dim=16, img_resolution=res, ngf=16, lite=lite)
    v = jax.jit(lambda k, z: jfast.FastGANGenerator(cfg).init(k, z, None, method=_call))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16)))
    rng = np.random.RandomState(5)

    def fill(path, leaf):
        leaf, names = np.asarray(leaf), [p.key for p in path]
        if names[-1].startswith("noise_strength") or names[-1] in ("bias", "scale"):
            return np.asarray(leaf + rng.randn(*leaf.shape) * 0.3, np.float32)
        return leaf

    return cfg, jax.tree_util.tree_map_with_path(fill, jax.tree_util.tree_map(np.asarray,
                                                                                dict(v)))


@pytest.mark.parametrize("lite,res", [(False, 64), (True, 32)])
def test_fastgan_matches_jax(lite, res):
    cfg, variables = jax_variables(lite, res)
    port = FastGANGenerator(FastGANConfig(z_dim=16, img_resolution=res, ngf=16, lite=lite),
                            device="cpu")
    load_jax_variables(port, variables)
    z = np.random.RandomState(6).randn(3, 16).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.jit(lambda v, z: jfast.FastGANGenerator(cfg).apply(
        v, z, key, method=_call))(variables, jnp.asarray(z)))
    noise = {}
    for name, shape in port.noise_shapes(3).items():
        r, idx = int(name.split(".")[0][5:]), int(name.split(".")[1])
        noise[name] = torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(key, r), idx), shape, jnp.float32)))
    with torch.no_grad():
        ws = port.map(torch.from_numpy(z))
        got = port.synthesize(ws, noise=noise)
    assert ws.shape == (3, 1, 16) and got.shape == want.shape == (3, res, res, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
    assert ("se_64" in dict(port.named_children())) == (res == 64)
    if not lite:
        assert len(noise) == 2 * 4
        without = port.synthesize(ws, noise={k: v * 0 for k, v in noise.items()}).detach()
        assert float((without - got).abs().max()) > 10 * TOL * np.abs(want).max()


def test_fastgan_default_noise_and_gradients():
    """Without ``noise`` the draws come from a generator seeded 0 (the same
    maps a call); gradients reach every parameter, the init's transposed
    conv among them."""
    port = FastGANGenerator(FastGANConfig(z_dim=16, img_resolution=32, ngf=16), device="cpu")
    with torch.no_grad():
        for n, p in port.named_parameters():
            if "noise_strength" in n:
                p.fill_(0.5)
    z = torch.randn(2, 16, generator=torch.Generator().manual_seed(2))
    a = port(z)
    assert torch.equal(a.detach(), port(z).detach())
    a.square().mean().backward()
    missing = [n for n, p in port.named_parameters() if p.grad is None or not p.grad.any()]
    assert not missing, missing
