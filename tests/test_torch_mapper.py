"""Parity of the port's StyleCLIP mapper, its losses and its coach with the
JAX package's, on the CPU.

The decoder is a slim SG3-R at 32² (`channel_base=2048, channel_max=64`, 7
layers: 9 styles, so the coarse, medium and fine mappers all run), the JAX
package's init with its zero leaves seeded (`generator_variables`). CLIP
has `test_torch_clip.TINY`'s widths at 224² (the loss pools every image to
224²), its leaves from `clip_variables`; the ID loss runs the 8-layer IR-SE
trunk (`test_torch_video_cli.py`'s), seeded by `init_module`. The JAX
`CLIPLoss` and `IDLoss` are given those networks by patching the names they
build (`CLIP`, `IRSEBackbone`) in their modules. The mappers' weights are
the JAX init's, copied into the port.

Tolerances, of max |ref| unless stated:
- `pixel_norm`, `Mapper`, `LevelsMapper`: 1e-5 (4 fp32 matmuls);
- the mapper net's image and ŵ, `CLIPLoss`, `IDLoss` and its parts: 1e-4
  (the generators' image tolerance; the losses sum a 2-block CLIP or an
  8-layer IR-SE in another order);
- three `train_step`s of `MapperCoach` (Ranger, lr 0.5, all three losses):
  each loss within 1e-4 relative plus 2⁻²⁰ (4 ulp of 1: the CLIP and ID
  losses are 1 − a cosine near 1, which cancels to the cosine's rounding);
  the mapper's parameters' change from their start (the weights are ~100,
  the steps far smaller) and Ranger's slow weights within 1e-4; the
  moments within 1e-3 (they are the gradients and
  their squares, through the decoder's backward, CLIP and IR-SE, whose sums
  run in another order: ~1e-5 relative in each gradient, more on entries
  far below the largest).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.criteria import clip_loss as jclip_loss
from stylegan3_editing_tpu.criteria import id_loss as jid_loss
from stylegan3_editing_tpu.editing import styleclip_mapper as jmapper
from stylegan3_editing_tpu.models.backbones import clip as jclip
from stylegan3_editing_tpu.models.backbones import irse as jirse
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu_torch.criteria import CLIPLoss, IDLoss
from stylegan3_editing_tpu_torch.editing import styleclip_mapper as mapper
from stylegan3_editing_tpu_torch.models.backbones import irse
from stylegan3_editing_tpu_torch.models.backbones.clip import CLIP
from stylegan3_editing_tpu_torch.models.sg3 import Generator, load_jax_variables, sg3_r_config
from test_torch_clip import TINY, clip_variables
from test_torch_encoders import check, generator_variables, init_module, seeded, t

torch.set_num_threads(1)

MLP_TOL = 1e-5
NET_TOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-4, 2.0 ** -20
PARAM_TOL = 1e-4
MOMENT_TOL = 1e-3
CLIP224 = dict(TINY, image_resolution=224)
DECODER = dict(channel_base=2048, channel_max=16, num_layers=7)
STEPS = 3


def _tokens(seed, n=1):
    """Token ids as the tokenizer writes them: start, words, end (the largest
    id), zeros."""
    rng = np.random.RandomState(seed)
    tok = np.zeros((n, 77), np.int32)
    for i in range(n):
        k = 3 + i
        tok[i, 0], tok[i, 1:k + 1], tok[i, k + 1] = 49406, rng.randint(1, 49000, k), 49407
    return tok


def _jax_irse8(**kw):
    return jirse.IRSEBackbone(**{**kw, "num_layers": 8})


@pytest.fixture(scope="module")
def nets():
    """The JAX and port networks with the same weights: decoder, CLIP, ID net."""
    cfg = jcfg.sg3_r_config(32, **DECODER)
    gen = generator_variables(cfg, seed=1)
    tcfg = sg3_r_config(32, **DECODER)
    G = Generator(tcfg, device="cpu")
    load_jax_variables(G, gen)
    jclip_model = jclip.CLIP(**CLIP224)
    cv = clip_variables(jclip_model, 2)
    clip = CLIP(**CLIP224, device="cpu")
    load_jax_variables(clip, cv)
    x0 = np.zeros((1, 112, 112, 3), np.float32)
    iv = init_module(_jax_irse8(input_size=112, mode="ir_se", drop_ratio=0.6), x0, seed=3)
    facenet = irse.IRSEBackbone(112, 8, "ir_se", drop_ratio=0.6)
    load_jax_variables(facenet, iv)
    return dict(cfg=cfg, tcfg=tcfg, gen=gen, G=G, cv=cv, clip=clip, iv=iv, facenet=facenet)


@pytest.fixture
def jax_losses(monkeypatch):
    """The JAX `CLIPLoss` and `IDLoss` build the test's CLIP and 8-layer trunk."""
    monkeypatch.setattr(jclip_loss, "CLIP", lambda: jclip.CLIP(**CLIP224))
    monkeypatch.setattr(jid_loss, "IRSEBackbone", _jax_irse8)


def _sub(variables, name):
    return {c: {name: v} for c, v in variables.items()}


# --------------------------------------------------------------- the mapper

def test_pixel_norm_matches_jax():
    x = seeded(3, 4, 512, seed=4) * 3
    check(mapper.pixel_norm(t(x)), jmapper.pixel_norm(jnp.asarray(x)), MLP_TOL, "pixel_norm")


@pytest.mark.parametrize("levels", [dict(), dict(no_medium_mapper=True),
                                    dict(no_coarse_mapper=True, no_fine_mapper=True)],
                         ids=["all", "no-medium", "medium-only"])
def test_levels_mapper_matches_jax(levels):
    x = seeded(2, 16, 512, seed=5)
    jm = jmapper.LevelsMapper(**levels)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    m = mapper.LevelsMapper(**levels)
    load_jax_variables(m, v)
    with torch.no_grad():
        got = m(t(x))
    check(got, jm.apply(v, x), MLP_TOL, f"LevelsMapper {levels}")
    for off, sl in (("no_coarse_mapper", slice(0, 5)), ("no_medium_mapper", slice(5, 8)),
                    ("no_fine_mapper", slice(8, None))):
        assert bool((got[:, sl] == 0).all()) == bool(levels.get(off))


def test_mapper_matches_jax():
    x = seeded(2, 3, 512, seed=6)
    v = jax.jit(jmapper.Mapper().init)(jax.random.PRNGKey(1), jnp.asarray(x))
    m = mapper.Mapper()
    load_jax_variables(m, v)
    assert m.fc0.lr_multiplier == 0.01
    with torch.no_grad():
        check(m(t(x)), jmapper.Mapper().apply(v, x), MLP_TOL, "Mapper")


def test_mapper_net_matches_jax(nets):
    """ŵ = w + 0.1 · mapper(w) and its fp32 image (the JAX default)."""
    cfg = nets["cfg"]
    jnet = jmapper.StyleCLIPMapperNet(cfg)
    w = seeded(2, cfg.num_ws, 512, seed=7)
    mv = jax.jit(jnet.init)(jax.random.PRNGKey(2), jnp.asarray(w))
    variables = {"params": {"mapper": mv["params"]["mapper"], "decoder": nets["gen"]["params"]},
                 "buffers": {"decoder": nets["gen"]["buffers"]},
                 "ema": {"decoder": nets["gen"]["ema"]}}
    net = mapper.StyleCLIPMapperNet(nets["tcfg"], decoder=nets["G"], device="cpu")
    load_jax_variables(net, variables)
    ref_img, ref_w = jax.jit(jnet.apply)(variables, w)
    with torch.no_grad():
        img, w_hat = net(t(w))
    check(w_hat, ref_w, MLP_TOL, "w_hat")
    check(img, ref_img, NET_TOL, "mapper net image")


# ------------------------------------------------------------------- losses

def test_clip_loss_matches_jax(nets, jax_losses):
    """At 32² the ×7 nearest resize reaches 224² and the pool's window is 1;
    at 64² the pool averages 2×2 of the 448² intermediate."""
    for size in (32, 64):
        img = np.tanh(seeded(2, size, size, 3, seed=8 + size))
        tok = _tokens(9, n=2)
        jl = jclip_loss.CLIPLoss(stylegan_size=size)
        ref = jax.jit(jl.apply)(_sub(nets["cv"], "model"), img, tok)
        got = CLIPLoss(size, model=nets["clip"])(t(img), tok)
        assert got.shape == (2, 2)
        check(got.detach(), ref, NET_TOL, f"CLIPLoss {size}")


def test_id_loss_matches_jax_and_detaches_the_target(nets, jax_losses):
    y_hat, y, x = (np.tanh(seeded(2, 256, 256, 3, seed=s)) for s in (10, 11, 12))
    jl = jid_loss.IDLoss()
    ref = jax.jit(jl.apply)(_sub(nets["iv"], "facenet"), y_hat, y, x)
    loss_fn = IDLoss(copy.deepcopy(nets["facenet"]))  # its weights get gradients here
    ty_hat, ty = t(y_hat).requires_grad_(), t(y).requires_grad_()
    loss, sim, logs = loss_fn(ty_hat, ty, t(x))
    check(loss.detach(), ref[0], NET_TOL, "IDLoss")
    check(sim.detach(), ref[1], NET_TOL, "IDLoss sim_improvement")
    for k in ("diff_target", "diff_input", "diff_views"):
        check(logs[k].detach(), ref[2][k], NET_TOL, f"IDLoss {k}")
    loss.backward()
    assert ty.grad is None and float(ty_hat.grad.abs().max()) > 0
    # Pooled to 256² first when the image is another size.
    small = [np.tanh(seeded(1, 64, 64, 3, seed=s)) for s in (13, 14, 15)]
    ref = jax.jit(jl.apply)(_sub(nets["iv"], "facenet"), *small)
    with torch.no_grad():
        check(loss_fn(*map(t, small))[0], ref[0], NET_TOL, "IDLoss at 64^2")


# -------------------------------------------------------------------- coach

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def coach_runs(nets):
    """Three train steps of both coaches on the same batches, the state after each."""
    cfg = nets["cfg"]
    tokens = _tokens(14)
    ws = [seeded(2, cfg.num_ws, 512, seed=20 + i) for i in range(STEPS)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jclip_loss, "CLIP", lambda: jclip.CLIP(**CLIP224))
        mp.setattr(jid_loss, "IRSEBackbone", _jax_irse8)
        jcoach = jmapper.MapperCoach(jmapper.MapperTrainOptions(stylegan_size=32), cfg,
                                     decoder_variables=nets["gen"],
                                     clip_variables=_sub(nets["cv"], "model"),
                                     id_variables=_sub(nets["iv"], "facenet"),
                                     text_tokens=tokens)
        coach = mapper.MapperCoach(mapper.MapperTrainOptions(stylegan_size=32),
                                   nets["tcfg"], decoder=nets["G"],
                                   clip_model=nets["clip"], facenet=nets["facenet"],
                                   text_tokens=tokens, device="cpu")
        load_jax_variables(coach.net.mapper, {"params": jcoach.variables["params"]["mapper"]})
        init = _flat(jcoach.variables["params"]["mapper"])
        runs = []
        for w in ws:
            ref = jcoach.train_step(w)
            got = coach.train_step(w)
            st = jcoach.opt_state
            radam = st.inner[-1][0]
            runs.append(dict(
                ref=ref, got=got,
                ref_params={k: v - init[k] for k, v in
                            _flat(jcoach.variables["params"]["mapper"]).items()},
                params={k: p.detach().numpy() - init[k]
                        for k, p in coach.net.mapper.named_parameters()},
                ref_state={"exp_avg": _flat(radam.mu), "exp_avg_sq": _flat(radam.nu),
                           "slow": _flat(st.slow)},
                state={k: {n: coach.optimizer.state[p][k].numpy().copy()
                           for n, p in coach.net.mapper.named_parameters()}
                       for k in ("exp_avg", "exp_avg_sq", "slow")}))
    return coach, runs


def test_coach_freezes_all_but_the_mapper(coach_runs):
    coach, _ = coach_runs
    assert all(p.requires_grad for p in coach.net.mapper.parameters())
    for frozen in (coach.net.decoder, coach.clip_loss, coach.id_loss):
        assert not any(p.requires_grad for p in frozen.parameters())
        assert all(p.grad is None for p in frozen.parameters())
    assert coach.global_step == STEPS


@pytest.mark.parametrize("step", range(STEPS))
def test_coach_train_steps_match_jax(coach_runs, step):
    """The three losses and their sum, the change of the mapper's parameters
    from their start, and Ranger's moments and slow weights after each step."""
    run = coach_runs[1][step]
    assert set(run["got"]) == set(run["ref"]) == {"loss", "loss_clip", "loss_id",
                                                  "loss_l2_latent"}
    for k, v in run["ref"].items():
        assert abs(run["got"][k] - v) <= LOSS_RTOL * abs(v) + LOSS_ATOL, (k, run["got"][k], v)
    assert set(run["params"]) == set(run["ref_params"])
    for k, v in run["ref_params"].items():
        check(run["params"][k], v, PARAM_TOL, f"step {step + 1} {k} change")
    for key, tol in (("exp_avg", MOMENT_TOL), ("exp_avg_sq", MOMENT_TOL), ("slow", PARAM_TOL)):
        for k, v in run["ref_state"][key].items():
            check(run["state"][key][k], v, tol, f"step {step + 1} {k} {key}")


def test_coach_needs_text_tokens(nets):
    cfg = nets["tcfg"]
    with pytest.raises(ValueError, match="tokenize"):
        mapper.MapperCoach(mapper.MapperTrainOptions(), cfg, decoder=nets["G"],
                           clip_model=nets["clip"], facenet=nets["facenet"], device="cpu")
