"""Parity of the port's ReStyle e4e coach with the JAX package's, on the CPU:
the latent discriminator with R1 and its pools, two progressive stages with
the delta loss, gradient accumulation across the optimizer step, a trained
decoder (``train_decoder=True``) and `validate`.

The coaches start from one carried state as in `test_torch_coach.py` (whose
helpers build them: the 32² tiny decoder, the 8-layer IR-SE trunk), with the
discriminator's seeded weights carried too. The options are
`scripts/train_e4e.sh`'s losses that need no pretrained net (L2 1, w-disc
0.1, the W pools, ψ 0.7) at batch 1 with one ReStyle iteration, an effective
batch of 2, ``progressive_steps=[0, 2]`` (stage 0 for micro-steps 1-2,
stage 1 from micro-step 3: the delta loss and the discriminator's dims
move), ``d_reg_every=2`` (R1 at micro-steps 1 and 3), pools of 2 (filled by
micro-step 2, then swapping) and ``train_decoder=True`` (the decoder's
parameters join Ranger, as for pSp: `Coach.trainable` is one code path for
both encoder types). Each micro-step's z is the JAX coach's own draw (its key
split as `train_discriminator` splits it), given to the port's `train_step`.

Tolerances, as `test_torch_coach.py` states them (its first run set the
gradient bound): metrics 1e-4 relative plus 2⁻²⁰; running statistics 1e-4
of max |ref|; every gradient-like tensor (the accumulator, Ranger's and the
discriminator's Adam moments) 1e-3 of its max |ref| plus 4 times the port's
own difference between its two conv backends (a third coach, oneDNN off)
plus 1e-6 of the quantity's largest |ref| entry (rounding noise);
parameters after Ranger's first step lr times the first moment's bound
over 1 − b1, plus 2 ulp; the discriminator's parameters within 2·lr an Adam
step (an entry moves about lr a step, and near a zero gradient rounding can
turn its sign) and all but 1 % of entries within 1e-3 of that; the pooled
codes 1e-4 of max |ref| (encoder outputs).
"""

import jax
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu_torch.training import E4eTrainOptions
from test_torch_coach import (STATS_TOL, allowed, backend_noise, check, check_gradients,
                              check_metrics, check_params, faces, flat, in_thread, jax_coach,
                              jax_opts, jax_state, port_coach, port_state, slim_nets,
                              with_onednn_off)

torch.set_num_threads(1)

STEPS = 3
E4E = dict(batch_size=1, effective_batch_size=2, n_iters_per_batch=1, l2_lambda=1.0,
           w_discriminator_lambda=0.1, d_reg_every=2, w_pool_size=2, truncation_psi=0.7,
           progressive_steps=[0, 2], train_decoder=True, output_size=32,
           encoder_type="ProgressiveBackboneEncoder")


def disc_noise(port, other):
    """Per tensor, max |port − other| of the discriminator's Adam moments."""
    named = list(zip(port.disc.named_parameters(), other.disc.parameters()))
    return {k: {n: float((port.disc_optimizer.state[p][k] - other.disc_optimizer.state[q][k])
                         .abs().max()) for (n, p), q in named}
            for k in ("exp_avg", "exp_avg_sq")}


def disc_state(c):
    """The discriminator's parameters and Adam moments, by flax path."""
    if hasattr(c, "disc_optimizer"):  # the port
        opt, named = c.disc_optimizer, list(c.disc.named_parameters())
        return {"params": {n: p.detach().numpy().copy() for n, p in named},
                **{k: {n: opt.state[p][k].numpy().copy() for n, p in named}
                   for k in ("exp_avg", "exp_avg_sq")}}
    adam = c.disc_opt_state[0]
    return {"params": flat(c.disc_variables["params"]), "exp_avg": flat(adam.mu),
            "exp_avg_sq": flat(adam.nu)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three micro-steps of both e4e coaches (and of the port with oneDNN off)
    on the same batches and z, the state after each; then `validate`."""
    tmp = tmp_path_factory.mktemp("e4e")
    data = faces(STEPS + 1, 1, seed=40)
    with pytest.MonkeyPatch.context() as mp:
        slim_nets(mp)
        opts = E4eTrainOptions(exp_dir=str(tmp), **E4E)
        port, other = port_coach(opts, seed=1), port_coach(opts, seed=1)
        jax_c = jax_coach(port, jax_opts(opts))
        disc0 = {n: p.detach().numpy().copy() for n, p in port.disc.named_parameters()}
        zs, key = [], jax_c._rng  # the draws of the JAX coach's D steps
        for _ in range(STEPS):
            key, sub = jax.random.split(key)
            zs.append(np.asarray(jax.random.normal(sub, (1, jax_c.decoder_cfg.z_dim))))

        def jax_run():
            out = [(jax_c.train_step(b), jax_state(jax_c), disc_state(jax_c),
                    list(jax_c.real_w_pool.ws), list(jax_c.fake_w_pool.ws))
                   for b in data[:STEPS]]
            return out, jax_c.validate(data[STEPS:])

        jax_steps = in_thread(jax_run)
        steps = []
        for batch, z in zip(data[:STEPS], zs):
            stage = port._current_stage()
            got = port.train_step(batch, z=z)
            with_onednn_off(lambda: other.train_step(batch, z=z))
            steps.append(dict(got=got, stage=stage, state=port_state(port),
                              noise=backend_noise(port, other), disc=disc_state(port),
                              disc_noise=disc_noise(port, other),
                              pools=(list(port.real_w_pool.ws), list(port.fake_w_pool.ws))))
        del other
        val = dict(got=port.validate(data[STEPS:]))
        ref_steps, val["ref"] = jax_steps()
        for step, (ref, ref_state, ref_disc, real, fake) in zip(steps, ref_steps):
            step.update(ref=ref, ref_state=ref_state, ref_disc=ref_disc,
                        pools=list(zip(step["pools"], (real, fake))))
        del jax_c
    decoder = [p.requires_grad for p in port.model.decoder.parameters()]
    return dict(steps=steps, val=val, opts=opts, disc0=disc0, decoder_requires_grad=decoder)


@pytest.mark.parametrize("step", range(STEPS))
def test_e4e_micro_steps_match_jax(runs, step):
    """The D step's and the G step's metrics; the encoder's statistics; the
    encoder's and the decoder's parameters, accumulator and Ranger state."""
    run = runs["steps"][step]
    check_metrics(run["got"], run["ref"], f"micro-step {step + 1}")
    want = {"discriminator_loss", "d_real_loss", "d_fake_loss", "encoder_discriminator_loss",
            "loss", "loss_l2", "loss_total", "total_delta_loss"}
    assert set(run["ref"]) == want | ({"discriminator_r1_loss"} if step != 1 else set())
    assert run["stage"] == (1 if step == 2 else 0)
    got, ref, noise = run["state"], run["ref_state"], run["noise"]
    assert any(k.startswith("decoder.") for k in got["params"])
    assert got["accum_count"] == ref["accum_count"] == (step + 1) % 2
    assert got["clock"] == ref["clock"] == (step + 1) // 2
    for k, v in ref["stats"].items():
        check(got["stats"][k], v, STATS_TOL, f"step {step + 1} {k}")
    check_gradients(got["accum"], ref["accum"], allowed(ref["accum"], noise["accum"]),
                    "accumulator")
    if step:
        for key in ("exp_avg", "exp_avg_sq"):
            check_gradients(got["ranger"][key], ref["ranger"][key],
                            allowed(ref["ranger"][key], noise[key]), key)
        step_bound(runs, got, ref, noise)
    else:
        for k, v in ref["params"].items():
            np.testing.assert_array_equal(got["params"][k], v)


def step_bound(runs, got, ref, noise):
    """The parameters after Ranger's first step, Δp = −lr·m̂ with m̂ = m / (1 −
    b1) (RAdam's unrectified branch): lr times the first moment's bound over
    1 − b1, plus 2 ulp."""
    bound = {k: v / (1 - 0.95) for k, v in
             allowed(ref["ranger"]["exp_avg"], noise["exp_avg"]).items()}
    check_params(got["params"], ref["params"], bound, runs["opts"].learning_rate / 2,
                 "parameters")


@pytest.mark.parametrize("step", range(STEPS))
def test_discriminator_steps_match_jax(runs, step):
    """Adam's moments and the discriminator's parameters after each D step
    (two Adam steps where R1 runs)."""
    run = runs["steps"][step]
    got, ref = run["disc"], run["ref_disc"]
    for key in ("exp_avg", "exp_avg_sq"):
        check_gradients(got[key], ref[key], allowed(ref[key], run["disc_noise"][key]),
                        f"discriminator {key}")
    # An Adam step moves an entry by lr·m̂/(√v̂ + eps), about lr: near a zero
    # gradient the two packages' rounding can turn its sign, so every entry is
    # within 2·lr a step, and all but 1 % within 1e-3 of that.
    lr = runs["opts"].w_discriminator_lr
    adam_steps = sum(2 if s != 1 else 1 for s in range(step + 1))
    for k, v in ref["params"].items():
        diff = np.abs(got["params"][k] - v)
        assert diff.max() <= 2 * lr * adam_steps, k
        assert (diff > 2e-3 * lr * adam_steps).mean() < 0.01, k
        assert np.abs(v - runs["disc0"][k]).max() > 0


def test_pools_hold_the_same_codes(runs):
    """Both packages' pools, seeded 0, took and swapped the same codes."""
    for i, run in enumerate(runs["steps"]):
        for got, ref in run["pools"]:
            assert len(got) == len(ref) == min(i + 1, 2)
            for g, r in zip(got, ref):
                check(g, r, 1e-4, f"pooled code after micro-step {i + 1}")


def test_validate_matches_jax(runs):
    """`validate` at stage 1: the last iteration's metrics, the encoder on its
    running statistics."""
    check_metrics(runs["val"]["got"], runs["val"]["ref"], "validate")
    assert set(runs["val"]["got"]) == {"encoder_discriminator_loss", "loss", "loss_l2",
                                       "total_delta_loss"}
    assert runs["val"]["got"]["total_delta_loss"] > 0


def test_decoder_trains(runs):
    """With ``train_decoder`` the decoder's parameters are in the optimizer and
    move at the optimizer step; the mapping network, which the codes do not
    reach, keeps its weights."""
    assert all(runs["decoder_requires_grad"])
    before, after = runs["steps"][0]["state"]["params"], runs["steps"][1]["state"]["params"]
    moved = {k for k in before if k.startswith("decoder.")
             and not np.array_equal(before[k], after[k])}
    assert any(k.startswith("decoder.synthesis.") for k in moved)
    assert not any(k.startswith("decoder.mapping.") for k in moved)
