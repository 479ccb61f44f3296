"""Parity of the port's SetGAN trainer with the JAX package's, on the CPU.

The slim configuration of the JAX package's own trainer tests: the 32²
decoder of `tests/test_setgan.py` (``tiny_cfg``: 4 layers of 32 channels,
fp32) with 64-wide latents (so the encoder's style heads stay small), the
8-layer IR-SE trunk at 64² references, one attention layer a style,
``tiny_proj`` for D with two 32-wide set heads, batch 2 with padded
reference and candidate slots, the blur at σ 2 (its fade's start), a G
warm-up over 2 steps and a G_ema half-life of 4 images. One tree of
variables serves both packages: G's seeded as `test_torch_setgan` seeds
them, D's from `jax.eval_shape` filled by numpy seeds; the JAX trainer is built
with its `jax.jit(init)` calls answered by those trees. The JAX steps'
noise and augment draws come from its key (`jax_draws` replays the
splits) and go into the port's `train_step`; the JAX step's gradients are
read inside its step (`jax.debug.callback` on the optimizer's input).
The JAX D and G steps, and the D step again in float64, compile once,
ahead of time and in three threads (XLA compiles without the GIL), at
XLA's backend optimisation level 0.

Tolerances:
- each step starts from the JAX step's state (`synced_step`): the port's
  optimizer results are recorded, then its parameters and Adam second
  moments are replaced by the JAX step's. Adam with β1 = 0 moves a first
  step's entries by ±lr·g/|g|, so an entry whose gradient is rounding in
  both packages may go either way and shift every later loss by more than
  its rounding;
- losses and statistics: `LOSS_TOL` = 1e-5 of max(1, |ref|) (fp32 sum
  order through the encoder, the style attention, 5 decoder layers and D);
- gradients, each bound from the JAX step alone: every tensor within
  `GRAD_TOL` = 1e-3 of the largest |entry| of JAX's gradients in its group
  (G's, D's), the chip's `GRAD_TOL`. D's group norms see channels whose
  variance is a small difference of large moments, and the fp32 rounding
  they amplify lands on whichever tensors the sum order picks: JAX's fp32
  D gradient sits up to 1.9e-3 of the group's largest entry from float64,
  on one tensor, and the port's up to 2.3e-3, on another. So each D
  tensor is held at `GRAD_TOL` plus the largest distance, over the group,
  of JAX's fp32 gradient to the JAX D step recomputed in float64 (under
  x64, from the same fake images, draws and masks; `jax_d_grads_f64`),
  and that distance is held under `F64_FAR` = 1e-2 of the largest entry;
- D's gradients in float64: `SetGANTrainer.d_loss_and_grads` with D in
  float64 within `F64_TOL` = 1e-9 of the group's largest entry of the JAX
  D step's in float64 (measured: 2.5e-14);
- parameters: each package's updated tensors within `PARAM_TOL` (1e-6 of
  max |p|, plus 1e-5 · lr) of optax's Adam (β1 = 0, β2 = 0.99, ε = 1e-8,
  the warm-up rate) applied in numpy to its own gradients from the same
  state; and the two packages' parameters within Adam's image of the
  gradient tolerance about JAX's gradient (Adam's step is increasing in
  the gradient, so the image of [g − tol, g + tol] bounds it), plus both
  PARAM_TOLs; G_ema likewise, with β = 0.5^(2/4);
- frozen tensors (the projector, and in the freeze tests the groups that
  do not train): byte for byte.

The tests of the port's trainer alone (the freeze phases, NaN scrubbing,
ADA, the CLI and the tick loop) are in `test_torch_setgan_train_cli.py`,
so that this file's eight JAX-synced tests can run on a worker of their
own.
"""

import copy
import functools
import threading
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu.parallel import create_mesh
from stylegan3_editing_tpu.parallel.mesh import batch_sharding
from stylegan3_editing_tpu.parallel.multiprocess import put_global_batch
from stylegan3_editing_tpu.setgan import model as jmodel
from stylegan3_editing_tpu.setgan import training_loop as jtl
from stylegan3_editing_tpu.setgan.loss import SetGANLossConfig as JLossConfig
from stylegan3_editing_tpu_torch.models.sg3 import SG3Config, load_jax_variables
from stylegan3_editing_tpu_torch.runtime.checkpoint import load_pytree
from stylegan3_editing_tpu_torch.setgan import (SetGANLossConfig, SetGANTrainConfig,
                                                SetGANTrainer)

from test_torch_feature_registry import seed_tree
from test_torch_encoders import JaxGenerator, seeded_variables
from test_torch_setgan import TINY
from test_torch_setgan_disc import jax_draws

torch.set_num_threads(1)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
PARAM_TOL = 1e-6
F64_FAR = 1e-2
F64_TOL = 1e-9
EMA_BETA = 0.5 ** (2 / 4)  # batch 2, ema_kimg 0.004, no ramp-up
CFG = dict(batch_size=2, d_backbones=("tiny_proj",), encoder_num_layers=8, ref_resolution=64,
           g_attn_layers=1, d_attn_layers=1, d_latent_size=32, d_num_discs=2, prefetch_batches=0,
           warmup_kimg=0.004, ema_kimg=0.004, ema_rampup=None)
LOSS = dict(blur_init_sigma=2.0, blur_fade_kimg=100)
B, R, C, REF, RES = 2, 3, 2, 64, 32
SLIM = {**TINY, "w_dim": 64, "z_dim": 64}
Z_DIM = SLIM["z_dim"]


def decoder_variables(cfg, seed):
    """The JAX generator's own init (its filters and Fourier features are
    buffers), then its zero leaves and EMAs seeded, as
    `test_torch_encoders.generator_variables` does at 512-wide latents."""
    variables = jax.jit(JaxGenerator(cfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, cfg.z_dim)))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        leaf, names = np.asarray(leaf), [p.key for p in path]
        if names[0] == "ema":
            return (np.abs(rng.randn(*leaf.shape)) + 0.5 if names[-1] == "magnitude_ema"
                    else rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        if names[0] == "params" and not leaf.any():
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, variables)


@functools.lru_cache(maxsize=None)
def g_variables():
    """The JAX SetGAN's tree for `SLIM`: the encoder and the style attention
    from numpy seeds, the decoder from its own init with its zero leaves
    and EMAs seeded (as `test_torch_setgan` makes its trees)."""
    model = jmodel.SetGAN(JSG3Config(**SLIM), attn_layers=1, encoder_num_layers=8)
    shapes = jax.eval_shape(functools.partial(model.init, latent_avg=jnp.zeros(Z_DIM)),
                            jax.random.PRNGKey(0), jnp.zeros((1, 1, REF, REF, 3)),
                            jnp.zeros((1, 1, Z_DIM)))
    gen = decoder_variables(JSG3Config(**SLIM), seed=3)
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
    return {"params": {"encoder": enc["params"], "decoder": gen["params"], "style_attn": attn},
            "batch_stats": {"encoder": enc["batch_stats"]},
            "buffers": {"decoder": gen["buffers"]}, "ema": {"decoder": gen["ema"]}}


def batch_np(seed):
    rng = np.random.RandomState(seed)
    return {"reference": np.tanh(rng.randn(B, R, REF, REF, 3)).astype(np.float32),
            "ref_mask": np.array([[True, True, False], [True, True, True]]),
            "candidate": np.tanh(rng.randn(B, C, RES, RES, 3)).astype(np.float32),
            "cand_mask": np.array([[True, False], [True, True]])}


def _flat(tree, prefix=""):
    out = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for k, v in items:
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, name))
        else:
            out[name] = np.array(v)
    return out


def port_config(**kw):
    return SetGANTrainConfig(**{**CFG, **kw}, loss=SetGANLossConfig(**LOSS))


def port_trainer(g_vars, d_vars, **kw):
    """A port trainer holding the JAX trainer's initial G, D and G_ema."""
    tr = SetGANTrainer(port_config(**kw), SG3Config(**SLIM), device="cpu")
    load_jax_variables(tr.G, g_vars)
    load_jax_variables(tr.G_ema, g_vars)
    load_jax_variables(tr.D, d_vars)
    tr.latent_avg = torch.from_numpy(np.array(g_vars["ema"]["decoder"]["mapping"]["w_avg"]))
    return tr


def build_jax_trainer(g_vars):
    """The JAX trainer with its `jax.jit(init)` answered by seeded trees, its
    state placed on the device, and its optimizers' gradients captured."""
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
        tr = jtl.SetGANTrainer(jtl.SetGANTrainConfig(**CFG, loss=JLossConfig(**LOSS)),
                               JSG3Config(**SLIM), mesh=create_mesh(devices=jax.devices()[:1]))
    finally:
        jax.jit = real_jit
    dev = jax.devices()[0]
    for k in ("g_vars", "d_vars", "g_opt", "d_opt", "pl_mean", "g_ema_params"):
        setattr(tr, k, jax.device_put(getattr(tr, k), dev))
    tr.captured = {"g": [], "d": [], "fake": []}

    def capturing(name, tx):
        def update(grads, state, params=None):
            jax.debug.callback(lambda g: tr.captured[name].append(
                jax.tree_util.tree_map(np.array, g)), grads)
            return tx.update(grads, state, params)
        return optax.GradientTransformation(tx.init, update)

    tr.g_tx, tr.d_tx = capturing("g", tr.g_tx), capturing("d", tr.d_tx)
    return tr


def jax_step_inputs(tr, batch):
    """The z and augment draws the JAX trainer's next `train_step` makes."""
    _, kz, kd, kg = jax.random.split(tr._rng, 4)
    z = np.array(jax.random.normal(kz, (B, C, Z_DIM)))
    n = B * C
    draws = {"fake": jax_draws(jax.random.fold_in(kd, 0), n, RES, RES),
             "real": jax_draws(jax.random.fold_in(kd, 1), n, RES, RES),
             "g": jax_draws(kg, n, RES, RES)}
    return torch.from_numpy(z), draws, kd


def conv_as_products(lhs, rhs, window_strides, padding, lhs_dilation=None, rhs_dilation=None,
                     dimension_numbers=None, feature_group_count=1, batch_group_count=1,
                     precision=None, preferred_element_type=None):
    """`lax.conv_general_dilated` as a product of patches and the kernel, for
    the float64 reference: XLA's CPU convolution has no fast float64 path.
    Undilated, with explicit or named padding; plain or depthwise (the two
    kinds the JAX D step runs: `nn.Conv` and `upfirdn2d`)."""
    assert all(d == 1 for d in (*(lhs_dilation or ()), *(rhs_dilation or ())))
    dn = lax.conv_dimension_numbers(lhs.shape, rhs.shape, dimension_numbers)
    x = jnp.transpose(lhs, (dn.lhs_spec[0], *dn.lhs_spec[2:], dn.lhs_spec[1]))  # NHWC
    w = jnp.transpose(rhs, (*dn.rhs_spec[2:], dn.rhs_spec[1], dn.rhs_spec[0]))  # HWIO
    kh, kw, ci, co = w.shape
    g = feature_group_count
    assert batch_group_count == 1 and (g == 1 or ci == 1 and co == g)
    if isinstance(padding, str):
        padding = lax.padtype_to_pads(x.shape[1:3], (kh, kw), window_strides, padding)
    x = jnp.pad(x, ((0, 0), *padding, (0, 0)))
    (sh, sw), n = window_strides, x.shape[0]
    oh, ow = (x.shape[1] - kh) // sh + 1, (x.shape[2] - kw) // sw + 1
    cols = jnp.stack([x[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw]
                      for i in range(kh) for j in range(kw)], axis=3)  # [n, oh, ow, taps, C]
    if g == 1:
        out = jnp.dot(cols.reshape(-1, kh * kw * ci), w.reshape(-1, co)).reshape(n, oh, ow, co)
    else:  # depthwise
        out = (cols * w.reshape(kh * kw, g)).sum(axis=3)
    perm = [0] * 4
    for src, dst in zip((0, 3, 1, 2), dn.out_spec):
        perm[dst] = src
    return jnp.transpose(out, perm)


@contextmanager
def x64_reference():
    """float64 for the JAX package (x64 on, for the callbacks' thread too),
    with `jax.random`'s uniform and integer draws made as the fp32 step
    makes them (under x64 they would be drawn as float64 and int64) and the
    convolutions as `conv_as_products`."""
    uniform, randint, conv = jax.random.uniform, jax.random.randint, lax.conv_general_dilated

    def uniform32(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return uniform(key, shape, jnp.float32, minval, maxval).astype(dtype)

    def randint32(key, shape, minval, maxval, dtype=jnp.int32):
        return randint(key, shape, minval, maxval, jnp.int32)

    jax.config.update("jax_enable_x64", True)
    jax.random.uniform, jax.random.randint = uniform32, randint32
    lax.conv_general_dilated = conv_as_products
    try:
        yield
    finally:
        jax.random.uniform, jax.random.randint, lax.conv_general_dilated = uniform, randint, conv
        jax.config.update("jax_enable_x64", False)


def _to64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.asarray(a), tree)


def _d_step64_args(tr, d_params, d_opt, batch, fake, key):
    return (_to64(d_params), _to64(d_opt), None,
            _to64({k: batch[k] for k in ("reference", "ref_mask", "candidate", "cand_mask")}),
            _to64(fake), key, np.float32(0.0))


def compile_steps(tr, batch):
    """Compile the JAX D and G steps ahead of time, and the D step again in
    float64 (`jax_d_grads_f64`), the three compiles in three threads, at
    XLA's backend optimisation level 0 (the same computation, compiled in a
    third of the time), and put the executables in the steps' place. Their
    arguments are made as `train_step` makes them, so each step calls the
    executables with the arguments they were lowered for. The fp32 D step
    also hands its fake images to ``tr.captured["fake"]``."""
    placed = dict(tr._place_batch(batch))
    placed.pop("_meta")
    z = put_global_batch(batch_sharding(tr.mesh), np.zeros((B, C, Z_DIM), np.float32))
    key = jax.random.PRNGKey(0)
    p0 = jnp.asarray(0.0, jnp.float32)
    sigma = float(np.round(LOSS["blur_init_sigma"], 1))
    run_g, d_vars = tr._run_g, tr.d_vars
    compiled, errors, threads = {}, [], []

    def compile_in_thread(name, lowered):  # each compile starts as its lowering ends
        def run():
            try:
                compiled[name] = lowered.compile(
                    compiler_options={"xla_backend_optimization_level": 0})
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                errors.append(e)

        threads.append(threading.Thread(target=run))
        threads[-1].start()

    def capturing_run_g(*args, **kwargs):
        imgs, ws = run_g(*args, **kwargs)
        jax.debug.callback(lambda x: tr.captured["fake"].append(np.array(x)), imgs)
        return imgs, ws

    tr._run_g = capturing_run_g
    try:
        compile_in_thread("d", tr._d_step.lower(tr.d_vars["params"], tr.d_opt,
                                                tr.g_vars["params"], placed, z, key, p0,
                                                blur_sigma=sigma))
        # G stood in by its images (passed as z), D's other collections in float64.
        tr._run_g = lambda g_params, batch, z, return_latents=True: (z, None)
        with x64_reference():
            tr.d_vars = _to64(d_vars)
            compile_in_thread("d64", jax.jit(tr._d_step_impl, static_argnames=(
                "blur_sigma",)).lower(*_d_step64_args(tr, d_vars["params"], tr.d_opt, batch,
                                                      np.zeros((B, C, RES, RES, 3)), key),
                                      blur_sigma=sigma))
    finally:
        del tr._run_g
        tr.d_vars = d_vars
    compile_in_thread("g", tr._g_step.lower(tr.g_vars["params"], tr.g_opt, tr.d_vars["params"],
                                            placed, z, key, tr.pl_mean, p0, blur_sigma=sigma,
                                            do_pl=False))
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

    def d_step(*args, blur_sigma):
        assert blur_sigma == sigma
        return compiled["d"](*args)

    def g_step(*args, blur_sigma, do_pl):
        assert blur_sigma == sigma and not do_pl
        return compiled["g"](*args)

    tr._d_step, tr._g_step, tr._d_step64 = d_step, g_step, compiled["d64"]


def jax_d_grads_f64(jt, d_params, d_opt, batch, fake, key):
    """The JAX package's D step (`_d_step_impl`) in float64, from the fp32
    step's D state, fake images (as its G rendered them), batch and key,
    with the augment draws that step made: its gradients by name."""
    jax.effects_barrier()
    n = len(jt.captured["d"])
    with x64_reference():
        jax.block_until_ready(jt._d_step64(*_d_step64_args(jt, d_params, d_opt, batch, fake,
                                                           key)))
        jax.effects_barrier()
    (grads,) = jt.captured["d"][n:]
    del jt.captured["d"][n:]
    return _flat(grads)


def port_d_grads_f64(port, batch, z, draws, fake):
    """`SetGANTrainer.d_loss_and_grads` with D in float64, on the given fake
    images (G stood in by them): its gradients by name."""
    tr = copy.copy(port)
    tr.D = copy.deepcopy(port.D).double()
    tr.d_params = {n: p for n, p in tr.D.named_parameters() if n in port.d_params}
    tr._run_g = lambda G, batch, z, *args, **kwargs: (torch.from_numpy(fake).double(), None)
    placed = {k: v.double() if v.is_floating_point() else v
              for k, v in port._place(batch).items()}
    _, _, grads = tr.d_loss_and_grads(placed, z, draws, float(np.round(LOSS["blur_init_sigma"], 1)))
    return {k: v.numpy() for k, v in grads.items()}


def _state(tr):
    return {"g": _flat(jax.tree_util.tree_map(np.array, tr.g_vars["params"])),
            "d": _flat(jax.tree_util.tree_map(np.array, tr.d_vars["params"])),
            "ema": _flat(jax.tree_util.tree_map(np.array, tr.g_ema_params))}


def _port_state(tr):
    return {"g": {n: p.detach().numpy().copy() for n, p in tr.G.named_parameters()},
            "d": {n: p.detach().numpy().copy() for n, p in tr.D.named_parameters()},
            "ema": {n: p.detach().numpy().copy() for n, p in tr.G_ema.named_parameters()}}


def _adam_nu(opt_state):
    """The second moments of an optax Adam state, by dotted parameter name."""
    (adam,) = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    return _flat(jax.tree_util.tree_map(np.array, adam.nu))


def synced_step(port, jt, batch, port_f64=False):
    """One JAX `train_step`, then the port's from the same noise and draws.
    Each of the port's optimizer steps is recorded, then its parameters and
    Adam second moments take the JAX step's (as G_ema after the step), so
    that every step starts from one state. Also records the JAX D step's
    gradients in float64 and, with ``port_f64``, the port's."""
    z, draws, kd = jax_step_inputs(jt, batch)
    before = _state(jt)
    before["nu"] = {"g": _adam_nu(jt.g_opt), "d": _adam_nu(jt.d_opt)}
    d_in = (jt.d_vars["params"], jt.d_opt)
    jm = jt.train_step(batch)
    after = _state(jt)
    nu_after = {"g": _adam_nu(jt.g_opt), "d": _adam_nu(jt.d_opt)}
    fake = jt.captured["fake"][-1]
    rec = {"before": before, "jax": after, "jax_metrics": jm,
           "jax_grads": {k: _flat(jt.captured[k][-1]) for k in ("g", "d")},
           "f64": {"d": jax_d_grads_f64(jt, *d_in, batch, fake, kd)},
           "port": {}, "port_grads": {}}
    if port_f64:
        rec["port_f64"] = {"d": port_d_grads_f64(port, batch, z, draws, fake)}
    adam_step = port._adam_step

    def adam(opt, params, grads, lr):
        group = "g" if opt is port.g_opt else "d"
        rec["port_grads"][group] = {k: v.numpy().copy() for k, v in grads.items()}
        adam_step(opt, params, grads, lr)
        rec["port"][group] = {n: p.detach().numpy().copy() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(torch.from_numpy(after[group][n]))
                opt.state[p]["exp_avg_sq"].copy_(torch.from_numpy(nu_after[group][n]))

    port._adam_step = adam
    try:
        pm = port.train_step(batch, z=z, draws=draws)
    finally:
        del port._adam_step
    rec["port_metrics"] = {k: float(v) for k, v in pm.items()}
    rec["port"]["ema"] = {n: p.numpy().copy() for n, p in port.G_ema.named_parameters()}
    rec["port"]["d_all"] = {n: p.detach().numpy().copy() for n, p in port.D.named_parameters()}
    with torch.no_grad():
        for n, p in port.G_ema.named_parameters():
            p.copy_(torch.from_numpy(after["ema"][n]))
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two synced steps from one state (G from `test_torch_setgan`'s seeds,
    D from the JAX trainer's). The second is stepped by a fresh port
    trainer restored from the snapshot the JAX trainer wrote after the
    first, so that it also shows the restored run going on as the JAX one."""
    g_vars = g_variables()
    jt = build_jax_trainer(g_vars)
    d_vars = jax.tree_util.tree_map(np.array, {"params": jt.d_vars["params"]})
    port = port_trainer(g_vars, d_vars)
    batches = [batch_np(s) for s in (1, 2, 3)]
    compile_steps(jt, batches[0])
    start = _port_state(port)
    steps = [synced_step(port, jt, batches[0], port_f64=True)]
    snap = tmp_path_factory.mktemp("jax_snap") / "snap"
    with pytest.MonkeyPatch.context() as mp:  # the JAX trainer writes on process 0 of 2
        mp.setattr(jax, "process_count", lambda: 2)
        mp.setattr(jax, "process_index", lambda: 0)
        jt.snapshot(snap)
    restored = port_trainer(g_vars, d_vars).restore(snap)
    at_snapshot = {"jax": _state(jt), "port": _port_state(restored)}
    steps.append(synced_step(restored, jt, batches[1]))
    return {"jt": jt, "port": restored, "start": start, "steps": steps, "batches": batches,
            "g_vars": g_vars, "d_vars": d_vars, "jax_snapshot": snap,
            "at_snapshot": at_snapshot}


def _close(got, want, tol, what):
    err = abs(got - want)
    assert err <= tol * max(1.0, abs(want)), (what, got, want)


def test_losses_and_statistics_match_jax(runs):
    for i, step in enumerate(runs["steps"]):
        assert step["port_metrics"].keys() == step["jax_metrics"].keys()
        for k, want in step["jax_metrics"].items():
            print(f"step {i} {k}: port {step['port_metrics'][k]:.8g}, jax {want:.8g}")
            _close(step["port_metrics"][k], want, LOSS_TOL, (i, k))


def grad_tolerances(step, group):
    """Each tensor's gradient tolerance, from the JAX step alone: `GRAD_TOL`
    of the group's largest |entry| in JAX's gradients, plus, for D, the
    largest distance over the group of JAX's fp32 gradient to its float64
    recomputation (the fp32 rounding that D's group norms amplify lands on
    whichever tensors the sum order picks, in either package)."""
    ref, exact = step["jax_grads"][group], step["f64"].get(group)
    names = step["port_grads"][group]
    scale = max(float(np.abs(ref[k]).max()) for k in names)
    far = 0.0 if exact is None else max(float(np.abs(ref[k] - exact[k]).max()) for k in names)
    return {k: GRAD_TOL * scale + far for k in names}, scale


def test_gradients_match_jax(runs):
    for i, step in enumerate(runs["steps"]):
        for group in ("g", "d"):
            port, ref = step["port_grads"][group], step["jax_grads"][group]
            if group == "d":  # the JAX projector's gradients exist, and are zeroed
                assert {k for k in ref if not k.startswith("proj_")} == set(port)
                # The recomputation is the step's own (its draws, its fakes).
                assert set(step["f64"]["d"]) == set(ref)
            else:
                assert set(ref) == set(port)
            tols, scale = grad_tolerances(step, group)
            assert max(tols.values()) <= (GRAD_TOL + F64_FAR) * scale, (i, group)
            worst = (0.0, None)
            for k in port:
                err = float(np.abs(port[k] - ref[k]).max())
                assert err <= tols[k], (i, group, k, err, tols[k])
                worst = max(worst, (err / tols[k], k))
            print(f"step {i} {group}: {len(port)} tensors, worst {worst[0]:.3g} of its "
                  f"tolerance on {worst[1]}, max |grad| {scale:.3g}, largest tolerance "
                  f"{max(tols.values()) / scale:.3g} of it")


def test_d_gradients_in_float64_match_jax(runs):
    """`SetGANTrainer.d_loss_and_grads` with D in float64 gives the JAX D
    step's float64 gradients from the same fakes, draws and masks, to
    `F64_TOL` of the group's largest |entry|."""
    step = runs["steps"][0]
    port, ref = step["port_f64"]["d"], step["f64"]["d"]
    assert all(v.dtype == np.float64 for v in (*port.values(), *ref.values()))
    scale = max(float(np.abs(ref[k]).max()) for k in port)
    err = max(float(np.abs(port[k] - ref[k]).max()) for k in port)
    print(f"D in float64: {len(port)} tensors, worst {err / scale:.3g} of max |grad| {scale:.3g}")
    assert err <= F64_TOL * scale


def adam_update(p, nu, g, lr, count):
    """optax.adam(lr, b1=0, b2=0.99) in float32 numpy from the second moments
    ``nu`` after ``count`` steps: p − lr·g / (√(ν' / (1 − β2^(count+1))) + ε)
    with ν' = β2·ν + (1 − β2)·g²."""
    f = np.float32
    nu = f(1 - 0.99) * g * g + f(0.99) * nu
    bc2 = f(1) - f(0.99) ** f(count + 1)
    return p + (-f(lr)) * (g / (np.sqrt(nu / bc2) + f(1e-8)))


def adam_direction(nu, g, count):
    """Adam's update direction in float64, increasing in ``g``."""
    return g / (np.sqrt((0.99 * nu + 0.01 * g * g) / (1 - 0.99 ** (count + 1))) + 1e-8)


def test_parameters_and_ema_match_jax_after_each_step(runs):
    warm = CFG["warmup_kimg"] * 1000 / CFG["batch_size"]
    lr_at = {"g": lambda c: np.float32(0.0025) * np.float32(min((c + 1) / warm, 1.0)),
             "d": lambda c: 0.002}
    for i, step in enumerate(runs["steps"]):
        for group in ("g", "d"):
            lr = lr_at[group](i)
            got = {"port": step["port"][group], "jax": {k: step["jax"][group][k]
                                                       for k in step["port"][group]}}
            grads = {"port": step["port_grads"][group],
                     "jax": {k: step["jax_grads"][group][k] for k in got["port"]}}
            tols, _ = grad_tolerances(step, group)
            n_apart = 0
            for k in got["port"]:
                p, nu = step["before"][group][k], step["before"]["nu"][group][k]
                want = {who: adam_update(p, nu, grads[who][k], lr, i) for who in got}
                tol = PARAM_TOL * float(np.abs(want["jax"]).max()) + 1e-5 * lr
                for who in ("port", "jax"):
                    err = float(np.abs(got[who][k] - want[who]).max())
                    assert err <= tol, (i, who, group, k, err, tol)
                # Adam's image of the gradient tolerance about JAX's gradient.
                g, d = grads["jax"][k].astype(np.float64), tols[k]
                mid = adam_direction(nu, g, i)
                width = lr * np.maximum(adam_direction(nu, g + d, i) - mid,
                                        mid - adam_direction(nu, g - d, i))
                apart = np.abs(got["port"][k].astype(np.float64) - got["jax"][k])
                assert (apart <= width + 2 * tol).all(), (i, group, k, float(apart.max()))
                n_apart += int(np.sum(apart > 1e-9))
            print(f"step {i} {group}: {len(got['port'])} tensors on Adam's update; "
                  f"{n_apart} entries where the two packages' parameters differ")
        # G_ema = p + β·(e − p) from the step's G (the JAX step's: the port's G
        # took it before its EMA) and the G_ema before.
        for k, got in step["port"]["ema"].items():
            prev, p = step["before"]["ema"][k], step["jax"]["g"][k]
            want = p + np.float32(EMA_BETA) * (prev - p)
            for who, value in (("port", got), ("jax", step["jax"]["ema"][k])):
                err = float(np.abs(value - want).max())
                assert err <= PARAM_TOL * float(np.abs(want).max()), (i, who, k, err)


def test_projector_frozen_byte_for_byte(runs):
    start = runs["start"]["d"]
    for step in runs["steps"]:
        for k, v in step["port"]["d_all"].items():
            if k.startswith("proj_"):
                assert v.tobytes() == start[k].tobytes(), k
                assert v.tobytes() == step["jax"]["d"][k].tobytes(), k
        assert set(step["port"]["d"]) == {k for k in start if not k.startswith("proj_")}


def test_warmup_learning_rate(runs):
    port = runs["port"]
    assert port.g_steps == port.d_steps == 2
    warm = CFG["warmup_kimg"] * 1000 / CFG["batch_size"]
    for step in range(4):
        assert port.g_lr_at(step) == pytest.approx(0.0025 * min((step + 1) / warm, 1.0))


def test_snapshot_restore_continues_as_one_run(runs, tmp_path):
    """The port's snapshot restored into a fresh trainer steps as the trainer
    that wrote it does, bit for bit."""
    port = runs["port"]
    port.snapshot(tmp_path / "snap")
    fresh = port_trainer(runs["g_vars"], runs["d_vars"]).restore(tmp_path / "snap")
    assert fresh.cur_nimg == port.cur_nimg == 4 and fresh.g_steps == 2
    z, draws, _ = jax_step_inputs(runs["jt"], runs["batches"][2])
    a = copy_step(port, runs["batches"][2], z, draws)
    b = copy_step(fresh, runs["batches"][2], z, draws)
    for group in a:
        for k in a[group]:
            assert a[group][k].tobytes() == b[group][k].tobytes(), (group, k)


def copy_step(tr, batch, z, draws):
    tr.train_step(batch, z=z, draws=draws)
    return _port_state(tr)


def test_jax_snapshot_restores_into_the_port(runs, tmp_path):
    """A snapshot the JAX trainer writes (numpy format) after the first step
    restores into the port byte for byte; the port then steps as the JAX
    trainer does (the second step of `runs`, held by the tests above); and
    the port's snapshot has the JAX snapshot's tree, leaf for leaf."""
    now = runs["at_snapshot"]["jax"]
    for group, state in runs["at_snapshot"]["port"].items():
        for k, v in state.items():
            assert v.tobytes() == now[group][k].tobytes(), (group, k)
    port = port_trainer(runs["g_vars"], runs["d_vars"]).restore(runs["jax_snapshot"])
    port.snapshot(tmp_path / "port_snap")
    jtree, jmeta = load_pytree(runs["jax_snapshot"])
    ptree, pmeta = load_pytree(tmp_path / "port_snap")
    fj, fp = _flat(jtree), _flat(ptree)
    assert fj.keys() == fp.keys()
    for k in fj:
        assert fj[k].shape == fp[k].shape and fj[k].dtype == fp[k].dtype, k
        np.testing.assert_array_equal(fp[k], fj[k], err_msg=k)
    assert pmeta["cur_nimg"] == jmeta["cur_nimg"] == 2 and port.g_steps == 1
