"""Parity of the port's SetGAN ``"sg2"`` stem (`models/sg2_stem.py`) with the
JAX package's, on the CPU.

The JAX `SG2Generator`'s own init gives the weights (``jax.jit(init)``),
its zero leaves (noise strengths, biases) seeded from numpy and carried
across through `load_jax_variables`. The JAX package draws each layer's
noise inside from ``fold_in(rng, …)``; the test draws the same maps with
the same keys and passes them to the port, with every noise strength
non-zero.

Tolerances: fp32 images within 1e-5 of max |ref| (fp32 sum order of XLA's
and oneDNN's convolutions over 4 blocks); with bf16 on the top two
resolutions within 2e-2 of max |ref| (bf16 roundings of the activations
and the lrelu's 0.2 in bf16, placed differently by the two packages); the
converter's tree equal to JAX's, to 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models import sg2_stem as jstem
from stylegan3_editing_tpu_torch.models.sg2_stem import SG2Config, SG2Generator, convert_sg2_state
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from stylegan3_editing_tpu_torch.models.sg3.from_jax import to_jax_variables

torch.set_num_threads(1)

FP32_TOL, BF16_TOL = 1e-5, 2e-2
SLIM = dict(z_dim=32, w_dim=32, img_resolution=32, channel_base=512, channel_max=64,
            mapping_layers=2)


@functools.lru_cache(maxsize=None)
def jax_variables(use_bf16: bool):
    cfg = jstem.SG2Config(**SLIM, use_bf16=use_bf16, num_fp16_res=2)
    v = jax.jit(jstem.SG2Generator(cfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 32)))
    rng = np.random.RandomState(3)

    def fill(path, leaf):
        leaf, names = np.asarray(leaf), [p.key for p in path]
        if names[-1] in ("noise_strength", "bias") or names[0] == "ema":
            return np.asarray(rng.randn(*leaf.shape) * 0.5, np.float32)
        return leaf

    return cfg, jax.tree_util.tree_map_with_path(fill, jax.tree_util.tree_map(np.asarray,
                                                                                dict(v)))


def jax_noise(cfg, batch, seed, dtypes):
    """The maps the JAX stem draws from ``PRNGKey(seed)``, by port layer name."""
    rng = jax.random.PRNGKey(seed)
    out = {}
    for i, res in enumerate(cfg.block_resolutions):
        first, second = jax.random.fold_in(rng, res), jax.random.fold_in(rng, res * 2 + 1)
        shape = (batch, res, res, 1)
        if res == 4:
            out["b4.conv1"] = jax.random.normal(first, shape, dtypes[i])
        else:
            out[f"b{res}.conv0"] = jax.random.normal(first, shape, dtypes[i])
            out[f"b{res}.conv1"] = jax.random.normal(second, shape, jnp.float32)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


@pytest.mark.parametrize("use_bf16", [False, True])
def test_sg2_stem_matches_jax(use_bf16):
    """map + synthesize with the noise passed in; the port's tree round-trips."""
    jcfg, variables = jax_variables(use_bf16)
    model = jstem.SG2Generator(jcfg)
    port = SG2Generator(SG2Config(**SLIM, use_bf16=use_bf16, num_fp16_res=2), device="cpu")
    load_jax_variables(port, variables)
    z = np.random.RandomState(4).randn(3, 32).astype(np.float32)
    ws = np.asarray(model.apply(variables, jnp.asarray(z), method=model.map))
    want = np.asarray(jax.jit(lambda v, w: model.apply(v, w, rng=jax.random.PRNGKey(7),
                                                       method=model.synthesize))(variables, ws))
    n_blocks = len(jcfg.block_resolutions)
    dtypes = [jnp.bfloat16 if use_bf16 and i >= n_blocks - 2 else jnp.float32
              for i in range(n_blocks)]
    noise = jax_noise(jcfg, 3, 7, dtypes)
    with torch.no_grad():
        got_ws = port.map(torch.from_numpy(z))
        got = port.synthesize(got_ws, noise=noise)
    np.testing.assert_allclose(got_ws.numpy(), ws, rtol=0, atol=1e-6 * np.abs(ws).max())
    assert got.dtype == torch.float32 and got.shape == (3, 32, 32, 3)
    tol = BF16_TOL if use_bf16 else FP32_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    without = port.synthesize(got_ws, noise={k: v * 0 for k, v in noise.items()}).detach()
    assert float((without - got).abs().max()) > 10 * tol * np.abs(want).max()
    back = to_jax_variables(port)
    for col in ("params", "ema"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, back[col],
                               jax.tree_util.tree_map(np.asarray, variables[col]))


def test_sg2_stem_noise_defaults_and_bf16_blocks():
    """Without ``noise`` the draws come from a generator seeded 0 (the same
    maps a call); ``generator`` draws others; bf16 enters at conv0 of the top
    ``num_fp16_res`` blocks only, and ``force_fp32`` keeps every block fp32."""
    port = SG2Generator(SG2Config(**SLIM, num_fp16_res=2), device="cpu")
    with torch.no_grad():
        for p in port.parameters():
            if p.ndim == 0:
                p.fill_(0.7)
        ws = port.map(torch.randn(2, 32, generator=torch.Generator().manual_seed(1)))
        a, b = port.synthesize(ws), port.synthesize(ws)
        c = port.synthesize(ws, generator=torch.Generator().manual_seed(5))
        seen = []
        hooks = [m.register_forward_pre_hook(lambda m, args, name=name: seen.append(
            (name, args[0].dtype))) for name, m in port.named_modules()
            if name.endswith(("conv0", "conv1"))]
        port.synthesize(ws)
        fp32 = port.synthesize(ws, force_fp32=True)
        for h in hooks:
            h.remove()
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(fp32).all()
    assert seen[:7] == [("b4.conv1", torch.float32), ("b8.conv0", torch.float32),
                        ("b8.conv1", torch.float32), ("b16.conv0", torch.bfloat16),
                        ("b16.conv1", torch.float32), ("b32.conv0", torch.bfloat16),
                        ("b32.conv1", torch.float32)]
    assert all(d == torch.float32 for _, d in seen[7:])
    assert port.num_ws == 8 and set(port.noise_shapes(2)) == {
        "b4.conv1", "b8.conv0", "b8.conv1", "b16.conv0", "b16.conv1", "b32.conv0", "b32.conv1"}


def sg2_reference_state(cfg, seed=0):
    """A seeded state dict in the reference's `networks_stylegan2` naming for
    ``cfg`` (with the blur taps and const-noise buffers the converter skips)."""
    rng = np.random.RandomState(seed)
    w = cfg.w_dim
    state = {"mapping.w_avg": rng.randn(w).astype(np.float32)}
    for i in range(cfg.mapping_layers):
        state[f"mapping.fc{i}.weight"] = rng.randn(w, cfg.z_dim if i == 0 else w).astype(
            np.float32)
        state[f"mapping.fc{i}.bias"] = rng.randn(w).astype(np.float32)
    for res in cfg.block_resolutions:
        ch, in_ch, b = cfg.channels(res), cfg.channels(max(res // 2, 4)), f"synthesis.b{res}"
        convs = [("conv1", ch, ch)] if res == 4 else [("conv0", in_ch, ch), ("conv1", ch, ch)]
        if res == 4:
            state[f"{b}.const"] = rng.randn(ch, 4, 4).astype(np.float32)
        for name, ci, co in convs:
            state[f"{b}.{name}.weight"] = rng.randn(co, ci, 3, 3).astype(np.float32)
            state[f"{b}.{name}.bias"] = rng.randn(co).astype(np.float32)
            state[f"{b}.{name}.noise_strength"] = np.float32(0.1)
            state[f"{b}.{name}.noise_const"] = rng.randn(res, res).astype(np.float32)
            state[f"{b}.{name}.resample_filter"] = np.ones((4, 4), np.float32)
            state[f"{b}.{name}.affine.weight"] = rng.randn(ci, w).astype(np.float32)
            state[f"{b}.{name}.affine.bias"] = rng.randn(ci).astype(np.float32)
        state[f"{b}.torgb.weight"] = rng.randn(3, ch, 1, 1).astype(np.float32)
        state[f"{b}.torgb.bias"] = rng.randn(3).astype(np.float32)
        state[f"{b}.torgb.affine.weight"] = rng.randn(ch, w).astype(np.float32)
        state[f"{b}.torgb.affine.bias"] = rng.randn(ch).astype(np.float32)
    return state


def test_convert_sg2_state_matches_jax():
    """A state dict in the reference's naming (`networks_stylegan2`): the
    port's converter gives the JAX converter's tree, and it loads."""
    cfg = SG2Config(**SLIM, use_bf16=False)
    state = sg2_reference_state(cfg)
    got = convert_sg2_state({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, cfg)
    want = jstem.convert_sg2_state(state, jstem.SG2Config(**SLIM, use_bf16=False))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, want))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                           jax.tree_util.tree_map(np.asarray, want))
    port = SG2Generator(cfg, device="cpu")
    load_jax_variables(port, got)
    np.testing.assert_array_equal(port.b4.const.detach().numpy(),
                                  state["synthesis.b4.const"].transpose(1, 2, 0))
