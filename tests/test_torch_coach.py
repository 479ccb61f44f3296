"""Parity of the port's ReStyle pSp coach with the JAX package's, on the CPU.

Both coaches start from one carried state: the port's `Coach` is built
(seeded weights; every batch norm of the encoder and of the ID net given
non-trivial statistics; the decoder's ``w_avg`` the mean of 64 mapped z),
and the JAX coach is assembled from it: `to_jax_variables` of its RestyleNet,
LPIPS and ID net, its ``latent_avg`` and its average image (building a JAX
`Coach` the usual way, with `jax.jit(init)`, costs ~60 s on the CPU; the JAX
coach's own `train_step`, `validate` and `_train_step_impl` run as they
are). The decoder is `tests/test_coach.py`'s 32² tiny SG3-R; the encoder
runs the 8-layer IR-SE trunk and the ID loss the 8-layer IR-SE net in both
packages (each package's encoder class with ``num_layers=8``, patched into
its `ENCODER_TYPES` and its ID loss's `IRSEBackbone`). The options are the
README's FFHQ losses (LPIPS 0.8, L2 1, ID 0.1) plus a w-norm term (0.01) at
batch 1 with an effective batch of 2 (two micro-steps an optimizer step)
and 2 ReStyle iterations; two micro-steps (one optimizer step) run in both
(`test_torch_coach_e4e.py` runs three with accumulation, the optimizer
step between them).

Tolerances. Stated before the first run:
- every metric of a micro-step and of `validate`: 1e-4 relative plus 2⁻²⁰
  (the ID loss is 1 − a cosine near 1, which cancels to the cosine's
  rounding; `MAPPER_LOSS_TOL` in `chip_smoke.py`);
- the batch norms' running statistics: 1e-4 of max |ref| (forward sums, as
  the encoders' tolerance in `test_torch_encoders.py`);
- a coach restored mid-accumulation and run on through `train` equals the
  uninterrupted run, to 0 (the same operations on the same inputs in one
  process).
The first run held the accumulator (the Welford mean of the gradients) to
1e-3 of each tensor's max |ref| and failed on 5 of 109 tensors: the
gradients that the train-mode batch norms cancel (a shortcut BN's bias,
whose gradient is 0 analytically, differed by ~1 of its max; the last trunk
block's conv1 kernel by 9e-3). The port run again with oneDNN's convs
switched off (PyTorch's own conv kernels, another summation order) differs
from itself by the same amounts (9e-3 and ~1 on those tensors): fp32
rounding that those gradients amplify, not a fault. So the fixture runs that
third coach too, and each gradient-like tensor (the accumulator, Ranger's
moments) is held to 1e-3 of its max |ref| plus 4 times the port's own
difference between its two conv backends on that tensor at that step (XLA
sums in a third order; two implementations' roundings add). A run with the
JAX steps in a thread beside the port's then failed on the second moment
of a shortcut BN's bias (2.6e-21 against 2.4e-21: its gradient is 0
analytically and reads ~3e-8 of the gradient's scale, so its moments are
rounding noise squared), so every bound also takes 1e-6 of the largest
|ref| entry of the whole quantity, below which an entry is rounding noise. Each parameter
is held to lr times its first moment's bound over 1 − b1 (Ranger's first
step is −lr·m̂, m̂ = m / (1 − b1)) plus 2 ulp of the parameter (each
package rounds p + Δp once; the change is ~100 ulp at lr 1e-4). The
detached variant (iteration 2 fed iteration 1's image and latent without
their graphs) must miss the accumulator's bound on most tensors.
"""

import functools
import json
import struct
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.criteria import IDLoss as JIDLoss
from stylegan3_editing_tpu.criteria import LPIPS as JLPIPS
from stylegan3_editing_tpu.criteria import id_loss as jid_loss
from stylegan3_editing_tpu.models.backbones import irse as jirse
from stylegan3_editing_tpu.models.encoders import backbones as jbackbones
from stylegan3_editing_tpu.models.encoders import restyle as jrestyle
from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu.runtime.training_stats import StatsCollector as JStats
from stylegan3_editing_tpu.training import coach as jcoach
from stylegan3_editing_tpu.training import options as joptions
from stylegan3_editing_tpu.utils import inference_utils as jinference
from stylegan3_editing_tpu_torch.criteria import id_loss as tid_loss
from stylegan3_editing_tpu_torch.models.backbones import irse as tirse
from stylegan3_editing_tpu_torch.models.backbones.common import BatchNorm
from stylegan3_editing_tpu_torch.models.encoders import backbones as tbackbones
from stylegan3_editing_tpu_torch.models.encoders import restyle as trestyle
from stylegan3_editing_tpu_torch.models.sg3 import SG3Config, to_jax_variables
from stylegan3_editing_tpu_torch.runtime.events import _masked_crc
from stylegan3_editing_tpu_torch.training import Coach, TrainOptions
from test_torch_encoders import check

torch.set_num_threads(1)

TINY = dict(img_resolution=32, channel_base=512, channel_max=32, num_layers=4, num_critical=2,
            use_bf16=False)  # tests/test_coach.py's tiny_cfg
LOSS_RTOL, LOSS_ATOL = 1e-4, 2.0 ** -20
GRAD_TOL = 1e-3
NOISE_FLOOR = 1e-6
STATS_TOL = 1e-4
STEPS = 2
PSP = dict(batch_size=1, effective_batch_size=2, n_iters_per_batch=2, lpips_lambda=0.8,
           l2_lambda=1.0, id_lambda=0.1, w_norm_lambda=0.01, output_size=32,
           board_interval=1, image_interval=1)


# ------------------------------------------------------------------ helpers

def slim_nets(mp):
    """The 8-layer IR-SE trunk for every encoder type and the ID net, in both
    packages."""
    for name in ("BackboneEncoder", "ProgressiveBackboneEncoder"):
        mp.setitem(jrestyle.ENCODER_TYPES, name,
                   functools.partial(getattr(jbackbones, name), num_layers=8))
        mp.setitem(trestyle.ENCODER_TYPES, name,
                   functools.partial(getattr(tbackbones, name), num_layers=8))
    mp.setattr(jid_loss, "IRSEBackbone", lambda **kw: jirse.IRSEBackbone(**{**kw, "num_layers": 8}))
    mp.setattr(tid_loss, "IRSEBackbone", lambda input_size, num_layers, mode, **kw:
               tirse.IRSEBackbone(input_size, 8, mode, **kw))


def seed_state(coach, seed):
    """Non-trivial batch-norm statistics and affines (so that no batch norm is
    the identity) and a ``w_avg`` from mapped z; the average image again."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in (coach.model.encoder, *coach.loss_nets().values()):
            for bn in (m for m in module.modules() if isinstance(m, BatchNorm)):
                c = bn.mean.shape[0]
                bn.mean.copy_(0.1 * torch.randn(c, generator=gen))
                bn.var.copy_(0.5 + torch.randn(c, generator=gen).abs())
                if bn.scale is not None:
                    bn.scale.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                    bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
        z = torch.randn((64, coach.decoder_cfg.z_dim), generator=gen)
        coach.model.decoder.mapping.w_avg.copy_(coach.model.decoder.map(z)[:, 0].mean(0))
    return coach.load_jax_state()


def port_coach(opts, seed=0):
    return seed_state(Coach(opts, decoder_cfg=SG3Config(**TINY), device="cpu"), seed)


def in_thread(fn):
    """Start ``fn`` in a thread and return a function that joins it and gives
    its result. XLA compiles and runs without the GIL, so the JAX coach's
    steps overlap the port's."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 (raised at the join)
            out["error"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["value"]

    return join


def jax_coach(port, jopts):
    """The JAX coach with the port coach's state, built as its `__init__`
    builds it from there."""
    c = object.__new__(jcoach.Coach)
    c.opts, c.is_e4e = jopts, isinstance(jopts, joptions.E4eTrainOptions)
    c.global_step, c.best_val_loss, c.stats = 0, None, JStats()
    c.decoder_cfg = JSG3Config(**TINY)
    c.n_styles = c.decoder_cfg.num_ws
    c.model = jrestyle.RestyleNet(decoder_cfg=c.decoder_cfg, encoder_type=jopts.encoder_type,
                                  n_styles=c.n_styles, input_nc=jopts.input_nc)
    c.variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(port.model))
    c.latent_avg = c.variables["ema"]["decoder"]["mapping"]["w_avg"]
    c.avg_image = jnp.asarray(port.avg_image.numpy())
    nets = {"lpips": JLPIPS(net_type="alex"), "id": JIDLoss()}
    c.loss_nets = {k: (nets[k], to_jax_variables(v)) for k, v in port.loss_nets().items()}
    c.tx = jcoach._make_optimizer(jopts)
    c.opt_state = c.tx.init(c._trainable(c.variables["params"]))
    c.disc = None
    if port.disc is not None:
        c.disc = jcoach.LatentCodesDiscriminator(c.decoder_cfg.w_dim, 4)
        c.disc_variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(port.disc))
        c.disc_tx = jcoach.optax.adam(jopts.w_discriminator_lr)
        c.disc_opt_state = c.disc_tx.init(c.disc_variables["params"])
        c.real_w_pool = jcoach.LatentCodesPool(jopts.w_pool_size)
        c.fake_w_pool = jcoach.LatentCodesPool(jopts.w_pool_size)
    c._train_step = jax.jit(c._train_step_impl, static_argnames=("stage",))
    c._val_step = jax.jit(c._val_step_impl, static_argnames=("stage",))
    c._rng = jax.random.PRNGKey(jopts.seed)
    return c


def jax_opts(opts):
    cls = joptions.E4eTrainOptions if hasattr(opts, "w_discriminator_lambda") \
        else joptions.TrainOptions
    return cls(**{f: getattr(opts, f) for f in cls.__dataclass_fields__})


def faces(n, batch, seed):
    """(x, y) pairs of seeded images in [-1, 1] at 256²."""
    rng = np.random.RandomState(seed)
    return [tuple(np.tanh(rng.randn(batch, 256, 256, 3)).astype(np.float32) for _ in range(2))
            for _ in range(n)]


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        out.update(flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def port_state(coach, start=None):
    """Trainable parameters, the encoder's batch-norm statistics, the
    accumulator and Ranger's moments and clock; whether Ranger's slow
    weights still equal ``start`` (parameters by name), when given."""
    opt = coach.optimizer
    stepped = [(n, p) for n, p in coach.trainable if p in opt.state]
    out = {
        "params": {n: p.detach().numpy().copy() for n, p in coach.trainable},
        "stats": {n: b.numpy().copy() for n, b in coach.model.named_buffers()
                  if n.startswith("encoder.")},
        "accum": {n: a.numpy().copy() for (n, _), a in zip(coach.trainable, coach.accum)},
        "accum_count": coach.accum_count,
        "ranger": {k: {n: opt.state[p][k].numpy().copy() for n, p in stepped}
                   for k in ("exp_avg", "exp_avg_sq")},
        "clock": opt.param_groups[0].get("step", 0)}
    if start is not None:
        out["slow_is_start"] = bool(stepped) and all(
            np.array_equal(opt.state[p]["slow"].numpy(), start[n]) for n, p in stepped)
    return out


def jax_state(c, start=None):
    st = c.opt_state
    look = st.inner_opt_state
    radam = look.inner[-1][0]
    out = {
        "params": flat(c._trainable(c.variables["params"])),
        "stats": flat(c.variables["batch_stats"]["encoder"], "encoder"),
        "accum": flat(st.acc_grads),
        "accum_count": int(st.mini_step),
        "ranger": {"exp_avg": flat(radam.mu), "exp_avg_sq": flat(radam.nu)},
        "clock": int(st.gradient_step)}
    if start is not None:
        out["slow_is_start"] = all(np.array_equal(v, start[k])
                                   for k, v in flat(look.slow).items())
    return out


def backend_noise(port, other):
    """Per tensor, max |port − other| of the accumulator and of Ranger's
    moments between two coaches that ran the same steps (``other`` with
    oneDNN's convs off)."""
    noise = {"accum": {n: float((a - b).abs().max()) for (n, _), a, b
                       in zip(port.trainable, port.accum, other.accum)}}
    for key in ("exp_avg", "exp_avg_sq"):
        noise[key] = {n: float((port.optimizer.state[p][key]
                                - other.optimizer.state[q][key]).abs().max())
                      for (n, p), (_, q) in zip(port.trainable, other.trainable)
                      if p in port.optimizer.state}
    return noise


def check_metrics(got, ref, what):
    assert set(got) == set(ref), (what, sorted(got), sorted(ref))
    for k, v in ref.items():
        assert abs(got[k] - v) <= LOSS_RTOL * abs(v) + LOSS_ATOL, (what, k, got[k], v)


def grad_errors(got, ref):
    """Each tensor's max |got − ref| over its max |ref| (tensors with a
    non-zero reference)."""
    return {k: float(np.abs(got[k] - r).max()) / float(np.abs(r).max())
            for k, r in ref.items() if np.abs(r).max() > 0}


def allowed(ref, noise):
    """Per tensor, the allowed max abs error of a gradient-like quantity: 1e-3
    of its max |ref|, plus 4 times the port's own difference between its two
    conv backends (``noise``, by tensor), plus 1e-6 of the largest |ref|
    entry of the whole quantity (rounding noise: what a gradient of 0
    analytically reads)."""
    floor = NOISE_FLOOR * max(float(np.abs(r).max()) for r in ref.values())
    return {k: GRAD_TOL * float(np.abs(r).max()) + 4 * noise[k] + floor
            for k, r in ref.items()}


def with_onednn_off(fn):
    with torch.backends.mkldnn.flags(enabled=False):
        return fn()


def check_gradients(got, ref, bound, what):
    assert set(got) == set(ref), what
    errors = grad_errors(got, ref)
    if errors:
        worst = max(errors.items(), key=lambda kv: kv[1])
        print(f"{what}: worst tensor {worst[0]}, max abs err / its max |ref| {worst[1]:.3g}")
    for k, r in ref.items():
        err = float(np.abs(got[k] - r).max())
        assert err <= bound[k], (what, k, err, bound[k], float(np.abs(r).max()))


def check_params(got, ref, accum_bound, lr, what):
    """Parameters after an update: lr times twice ``accum_bound``, plus 2 ulp
    of the parameter."""
    for k, r in ref.items():
        tol = 2 * lr * accum_bound[k] + 2 * np.spacing(np.abs(r).astype(np.float32))
        assert (np.abs(got[k] - r) <= tol).all(), (what, k, float(np.abs(got[k] - r).max()))


# ------------------------------------------------------------------- fixture

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two micro-steps of both pSp coaches on the same batches, the state
    after each, and of the port again with oneDNN's convs off; a checkpoint
    after the first; the detached variant's gradients of the first batch;
    and a coach restored from the checkpoint, run on through `train` for
    the second batch."""
    tmp = tmp_path_factory.mktemp("coach")
    data = faces(STEPS, 1, seed=30)
    with pytest.MonkeyPatch.context() as mp:
        slim_nets(mp)
        opts = TrainOptions(exp_dir=str(tmp / "run"), **PSP)
        port, other = port_coach(opts), port_coach(opts)
        start = to_jax_variables(port.model)
        params0 = {n: p.detach().numpy().copy() for n, p in port.trainable}
        jax_c = jax_coach(port, jax_opts(opts))
        jax_steps = in_thread(lambda: [(jax_c.train_step(b), jax_state(jax_c, params0))
                                       for b in data])
        steps = []
        for i, batch in enumerate(data):
            got = port.train_step(batch)
            with_onednn_off(lambda: other.train_step(batch))
            steps.append(dict(got=got, state=port_state(port, params0),
                              noise=backend_noise(port, other)))
            if i == 0:
                port.checkpoint(tmp / "mid")
        del other

        class Detached(Coach):
            def _restyle_forward(self, x, train, stage, impl="auto"):
                n = x.shape[0]
                y_hat = self.avg_image[None].expand((n,) + tuple(self.avg_image.shape))
                latent, outputs = None, []
                for _ in range(self.opts.n_iters_per_batch):
                    x_input = torch.cat([x, y_hat.detach()], dim=-1)
                    y_hat, latent = self.model(
                        x_input, latent=None if latent is None else latent.detach(),
                        latent_avg=self.latent_avg, train=train, stage=stage, impl=impl)
                    outputs.append((y_hat, latent))
                return outputs

        detached = seed_state(Detached(opts, decoder_cfg=SG3Config(**TINY), device="cpu"), 0)
        detached.load_jax_state(start)
        _, detached_grads = detached.loss_and_grads(data[0])
        detached_grads = {n: g.numpy() for n, g in detached_grads.items()}
        del detached

        # The loss nets are seeded as the run's were (the checkpoint holds
        # the trained state only); the restore replaces the rest.
        resumed = port_coach(TrainOptions(**{**vars(opts), "exp_dir": str(tmp / "resumed")}))
        resumed.restore(tmp / "mid")
        resumed_step = resumed.global_step
        resumed.train(iter(data[1:2]), max_steps=2)
        resumed = dict(state=port_state(resumed, params0), global_step=resumed.global_step)
        jax_loaded = jinference.load_encoder(str(tmp / "mid"))[1:]
        (tmp / "mid" / "arrays.npz").unlink()  # ~1.3 GB at this size
        for step, (ref, ref_state) in zip(steps, jax_steps()):
            step.update(ref=ref, ref_state=ref_state)
        del jax_c
    frozen = [p for m in (port.model.decoder, *port.loss_nets().values()) for p in m.parameters()]
    return dict(steps=steps, tmp=tmp, start=start, opts=opts, detached=detached_grads,
                resumed=resumed, resumed_step=resumed_step, jax_loaded=jax_loaded,
                trainable=[n for n, _ in port.trainable],
                trainable_grads=[p.grad for _, p in port.trainable],
                frozen=[(p.requires_grad, p.grad is not None) for p in frozen])


# --------------------------------------------------------------------- tests

@pytest.mark.parametrize("step", range(STEPS))
def test_psp_micro_steps_match_jax(runs, step):
    """Each micro-step's metrics, the encoder's batch-norm statistics and
    parameters, the accumulator and its count, and Ranger's moments, slow
    weights and clock."""
    run = runs["steps"][step]
    check_metrics(run["got"], run["ref"], f"micro-step {step + 1}")
    assert set(run["ref"]) == {"id_improve", "loss", "loss_id", "loss_l2", "loss_lpips",
                               "loss_total", "loss_w_norm"}
    got, ref, noise = run["state"], run["ref_state"], run["noise"]
    assert got["accum_count"] == ref["accum_count"] == (step + 1) % 2
    assert got["clock"] == ref["clock"] == (step + 1) // 2
    for k, v in ref["stats"].items():
        check(got["stats"][k], v, STATS_TOL, f"step {step + 1} {k}")
    if step == 0:
        check_gradients(got["accum"], ref["accum"], allowed(ref["accum"], noise["accum"]),
                        "accumulator")
        assert not got["ranger"]["exp_avg"]  # the optimizer has not stepped
        for k, v in ref["params"].items():
            np.testing.assert_array_equal(got["params"][k], v)
    else:
        assert not any(np.abs(a).max() for a in got["accum"].values())  # reset
        for key in ("exp_avg", "exp_avg_sq"):
            check_gradients(got["ranger"][key], ref["ranger"][key],
                            allowed(ref["ranger"][key], noise[key]), key)
        assert got["slow_is_start"] and ref["slow_is_start"]  # no lookahead sync yet
        # Ranger's first step, Δp = −lr·m̂ with m̂ = m / (1 − b1) (RAdam's
        # unrectified branch): lr times the first moment's bound over 1 − b1.
        bound = {k: v / (1 - 0.95) for k, v in allowed(
            ref["ranger"]["exp_avg"], noise["exp_avg"]).items()}
        check_params(got["params"], ref["params"], bound, runs["opts"].learning_rate / 2,
                     f"step {step + 1} parameters")


def test_parameters_move_at_the_optimizer_step_only(runs):
    """The parameters stay at micro-step 1 and move at 2; the statistics move
    at both."""
    steps = runs["steps"]
    start = {**flat(runs["start"]["params"]["encoder"], "encoder")}
    start_stats = flat(runs["start"]["batch_stats"]["encoder"], "encoder")
    for i, run in enumerate(steps):
        prev = start if i == 0 else steps[i - 1]["state"]["params"]
        moved = any(not np.array_equal(run["state"]["params"][k], v) for k, v in prev.items())
        assert moved == (i == 1), i
        prev = start_stats if i == 0 else steps[i - 1]["state"]["stats"]
        assert all(not np.array_equal(run["state"]["stats"][k], v) for k, v in prev.items()), i


def test_frozen_parts_get_no_gradient(runs):
    assert all(n.startswith("encoder.") for n in runs["trainable"])
    assert runs["frozen"] and not any(flag for pair in runs["frozen"] for flag in pair)
    assert all(g is None for g in runs["trainable_grads"])


def test_gradient_crosses_the_iterations(runs):
    """The JAX coach differentiates through both iterations (its accumulator
    after the first micro-step is the first batch's gradient); the port
    holds it, and a variant that detaches iteration 1's image and latent
    from iteration 2 misses it."""
    first = runs["steps"][0]
    ref = first["ref_state"]["accum"]
    bound = allowed(ref, first["noise"]["accum"])
    check_gradients(first["state"]["accum"], ref, bound, "accumulator")
    misses = [k for k, r in ref.items()
              if float(np.abs(runs["detached"][k] - r).max()) > bound[k]]
    worst = max(grad_errors(runs["detached"], ref).values())
    print(f"detached variant: {len(misses)} of {len(ref)} tensors miss the bound; worst max "
          f"abs err / max |ref| {worst:.3g}")
    assert len(misses) > len(ref) // 2


def test_restore_mid_accumulation_continues_the_run(runs):
    """A coach restored from the checkpoint after micro-step 1 and run through
    `train` on the second batch equals the uninterrupted run after
    micro-step 2: metrics, parameters, statistics, accumulator, Ranger."""
    resumed, uninterrupted = runs["resumed"], runs["steps"][1]
    assert runs["resumed_step"] == 1 and resumed["global_step"] == 2
    state = resumed["state"]
    for key in ("params", "stats", "accum"):
        for k, v in uninterrupted["state"][key].items():
            np.testing.assert_array_equal(state[key][k], v, err_msg=f"{key} {k}")
    for key, tensors in uninterrupted["state"]["ranger"].items():
        assert set(state["ranger"][key]) == set(tensors)
        for k, v in tensors.items():
            np.testing.assert_array_equal(state["ranger"][key][k], v, err_msg=f"{key} {k}")
    assert state["clock"] == uninterrupted["state"]["clock"] == 1 and state["slow_is_start"]
    entry = json.loads((runs["tmp"] / "resumed" / "stats.jsonl").read_text().splitlines()[-1])
    assert entry["step"] == 2 and "Timing/coach_step" in entry
    assert {k: entry[k] for k in uninterrupted["got"]} == uninterrupted["got"]


def test_train_writes_events_and_image_grids(runs):
    """`train`'s event file: the header and one scalar record per metric, each
    framed with its masked crc32c; and the image grid of the step."""
    logs = runs["tmp"] / "resumed" / "logs"
    assert (logs / "images_000002.png").exists()
    data = next(logs.glob("events.out.tfevents.*")).read_bytes()
    records, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == _masked_crc(header)
        body = data[pos + 12:pos + 12 + length]
        assert struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])[0] == \
            _masked_crc(body)
        records.append(body)
        pos += 16 + length
    metrics = runs["steps"][1]["got"]
    assert b"brain.Event:2" in records[0]
    scalars = [r for r in records[1:] if b"reconstructions" not in r]
    assert len(scalars) == len(metrics)
    for record, (tag, value) in zip(scalars, metrics.items()):
        assert tag.encode() in record and struct.pack("<f", value) in record
    assert any(b"reconstructions" in r and b"PNG" in r for r in records)


def test_checkpoint_is_in_the_jax_layout(runs):
    """The JAX package's `load_encoder` reads the port's mid-accumulation
    checkpoint: its variables are the port coach's at that point, in the
    JAX coach's tree."""
    variables, opts = runs["jax_loaded"]
    assert type(opts) is joptions.TrainOptions and opts.lpips_lambda == PSP["lpips_lambda"]
    got = flat(variables)
    assert set(got) == set(flat(runs["start"]))
    for k, v in runs["steps"][0]["ref_state"]["stats"].items():
        check(got[f"batch_stats.{k}"], v, STATS_TOL, f"checkpoint {k}")
    for k, v in runs["steps"][0]["state"]["params"].items():
        np.testing.assert_array_equal(got[f"params.{k}"], v)
