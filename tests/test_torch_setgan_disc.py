"""Parity of the port's SetGAN discriminator side with the JAX package's, on the CPU.

DiffAugment's ops given the random numbers the JAX package draws from its
key (`jax_draws` replays its key splits); ADA's controller and gate; the
blur and both losses; `SingleDisc`, `MultiSetComparator` with set masks,
`FeatureProjector` with and without remat, and `ProjectedSetDiscriminator`
on ``tiny_proj`` and ``vgg16_proj``, all from the JAX modules' variables
(`jax.eval_shape`, leaves seeded with numpy) carried in by
`load_jax_variables`; the padded slots' invariance; `path_length_penalty`
on a plain function of ``ws``; `runtime.util` (no module of either package
calls it; the JAX package's `runtime/__init__` re-exports it).

Tolerances: brightness, translation and cutout are exact (an add, a
gather, a mask); saturation and contrast sum a mean, in another order:
within 2^-22 of max |ref|. The blur, the losses, the projector and the
logits within 1e-5 of max |ref| (fp32 sum order); the path-length penalty
within 1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.setgan import ada as jada
from stylegan3_editing_tpu.setgan import discriminator as jdisc
from stylegan3_editing_tpu.setgan import loss as jloss
from stylegan3_editing_tpu.setgan.diffaugment import diff_augment as jax_diff_augment
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from stylegan3_editing_tpu_torch.setgan import (AdaController, FeatureProjector, MultiSetComparator,
                                                ProjectedSetDiscriminator, SetGANLossConfig,
                                                SingleDisc, apply_ada, apply_augment,
                                                blur_images, blur_sigma_at, d_main_loss,
                                                draw_augment, g_main_loss, path_length_penalty,
                                                projector_param_mask)

from test_torch_feature_registry import seed_tree

torch.set_num_threads(1)

TOL = 1e-5
MEAN_TOL = 2.0 ** -22


def jax_draws(key, n, h, w, policy="color,translation,cutout"):
    """The draws `jax_diff_augment(key, x)` makes for ``n`` images of h × w,
    in the port's layout (`draw_augment`), and the ADA gate's ``keep_u``
    (``uniform(fold_in(key, 17))``, as `ProjectedSetDiscriminator` draws it)."""
    out = {}
    k = key
    for name in policy.split(","):
        for op in {"color": ("brightness", "saturation", "contrast"),
                   "translation": ("translation",), "cutout": ("cutout",)}[name]:
            k, sub = jax.random.split(k)
            if op in ("brightness", "saturation", "contrast"):
                u = jax.random.uniform(sub, (n, 1, 1, 1), jnp.float32)
                v = {"brightness": u - 0.5, "saturation": u * 2, "contrast": u + 0.5}[op]
                out[op] = np.asarray(v).reshape(n)
            elif op == "translation":
                sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
                kx, ky = jax.random.split(sub)
                out["tx"] = np.asarray(jax.random.randint(kx, (n,), -sh, sh + 1))
                out["ty"] = np.asarray(jax.random.randint(ky, (n,), -sw, sw + 1))
            else:
                ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
                kx, ky = jax.random.split(sub)
                out["cy"] = np.asarray(jax.random.randint(kx, (n, 1, 1), 0, h + (1 - ch % 2))
                                       ).reshape(n)
                out["cx"] = np.asarray(jax.random.randint(ky, (n, 1, 1), 0, w + (1 - cw % 2))
                                       ).reshape(n)
    out["keep_u"] = np.asarray(jax.random.uniform(jax.random.fold_in(key, 17),
                                                  (n, 1, 1, 1))).reshape(n)
    return {k_: torch.from_numpy(np.array(v).astype(np.int64 if v.dtype.kind == "i"
                                                      else np.float32))
            for k_, v in out.items()}


def _images(shape, seed):
    return np.tanh(np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _close(got, want, tol, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    print(f"{what}: max abs err {err:.3g}, max |ref| {scale:.3g}")
    assert got.shape == want.shape and err <= tol * scale, what


@pytest.mark.parametrize("policy", ["color", "translation", "cutout",
                                    "color,translation,cutout"])
def test_diffaugment_matches_jax_draws(policy):
    x = _images((5, 24, 20, 3), 0)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_diff_augment(key, jnp.asarray(x), policy))
    draws = jax_draws(key, 5, 24, 20, policy)
    got = apply_augment(torch.from_numpy(x), draws, policy).numpy()
    if policy in ("translation", "cutout"):
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want, MEAN_TOL, policy)
    # The port's own draws have the JAX draws' ranges and dtypes.
    own = draw_augment(5, 24, 20, torch.Generator().manual_seed(0), policy=policy)
    assert set(own) == set(draws) - {"keep_u"}
    for k, v in own.items():
        assert v.dtype == draws[k].dtype and v.shape == (5,), k


def test_brightness_draw_is_exact():
    """The brightness op given JAX's draw is JAX's `rand_brightness`, bit for bit."""
    from stylegan3_editing_tpu.setgan.diffaugment import rand_brightness

    x = _images((4, 16, 16, 3), 1)
    key = jax.random.PRNGKey(9)
    want = np.asarray(rand_brightness(jax.random.split(key)[1], jnp.asarray(x)))
    got = torch.from_numpy(x) + jax_draws(key, 4, 16, 16, "color")["brightness"][:, None, None,
                                                                                 None]
    np.testing.assert_array_equal(got.numpy(), want)


def test_ada_controller_and_gate_match_jax():
    signs = np.random.RandomState(2).uniform(-1, 1, 40)
    for target, interval in ((0.6, 4), (-0.2, 9)):
        j = jada.AdaController(target=target, interval_imgs=interval, ada_kimg=0.01)
        p = AdaController(target=target, interval_imgs=interval, ada_kimg=0.01)
        for s in signs:
            assert p.update(s, 2) == j.update(s, 2)
        assert p.state.__dict__ == j.state.__dict__
    x = _images((6, 16, 16, 3), 3)
    key = jax.random.PRNGKey(5)
    for prob in (0.0, 0.4, 1.0):
        want = np.asarray(jada.apply_ada(key, jnp.asarray(x), prob))
        k_aug, k_mask = jax.random.split(key)
        draws = jax_draws(k_aug, 6, 16, 16)
        keep_u = torch.from_numpy(np.array(jax.random.uniform(k_mask, (6, 1, 1, 1))).reshape(6))
        got = apply_ada(torch.from_numpy(x), prob, draws=draws, keep_u=keep_u)
        _close(got, want, MEAN_TOL, f"apply_ada p={prob}")


@pytest.mark.parametrize("sigma", [0.0, 0.3, 1.0, 2.0])
def test_blur_and_losses_match_jax(sigma):
    imgs = _images((2, 3, 20, 20, 3), 4)
    _close(blur_images(torch.from_numpy(imgs), sigma),
           jloss.blur_images(jnp.asarray(imgs), sigma), TOL, f"blur sigma {sigma}")
    cfg = SetGANLossConfig(blur_init_sigma=2.0, blur_fade_kimg=100)
    jcfg = jloss.SetGANLossConfig(blur_init_sigma=2.0, blur_fade_kimg=100)
    for nimg in (0, 25_000, 99_999, 100_000, 200_000):
        assert blur_sigma_at(nimg, cfg) == jloss.blur_sigma_at(nimg, jcfg)
    rng = np.random.RandomState(5)
    real, fake = rng.randn(4, 8).astype(np.float32), rng.randn(4, 8).astype(np.float32)
    _close(g_main_loss(torch.from_numpy(fake)), jloss.g_main_loss(jnp.asarray(fake)), TOL, "G")
    loss, stats = d_main_loss(torch.from_numpy(real), torch.from_numpy(fake))
    jl, js = jloss.d_main_loss(jnp.asarray(real), jnp.asarray(fake))
    _close(loss, jl, TOL, "D")
    assert stats.keys() == js.keys()
    for k in js:
        _close(stats[k], js[k], TOL, k)


def test_path_length_penalty_matches_jax():
    """On a plain function of ws (no generator): images = tanh(ws @ A)."""
    rng = np.random.RandomState(6)
    ws = rng.randn(3, 4, 8).astype(np.float32)
    a = rng.randn(8, 2 * 5 * 3).astype(np.float32) * 0.3
    cfg = SetGANLossConfig(pl_weight=2.0)
    key = jax.random.PRNGKey(4)

    def jfn(w):
        return jnp.tanh(jnp.einsum("nsd,de->ne", w, a)).reshape(-1, 2, 5, 3)

    want, want_mean, want_stats = jloss.path_length_penalty(
        jfn, jnp.asarray(ws), jnp.asarray(0.5), key,
        jloss.SetGANLossConfig(pl_weight=2.0))
    noise = np.array(jax.random.normal(key, (3, 2, 5, 3)))
    at = torch.from_numpy(a)
    wt = torch.from_numpy(ws).requires_grad_(True)
    got, got_mean, stats = path_length_penalty(
        lambda w: torch.tanh(torch.einsum("nsd,de->ne", w, at)).reshape(-1, 2, 5, 3), wt,
        torch.tensor(0.5), cfg, noise=torch.from_numpy(noise))
    _close(got, want, TOL, "penalty")
    _close(got_mean, want_mean, TOL, "pl_mean")
    _close(stats["Loss/pl_penalty"], want_stats["Loss/pl_penalty"], TOL, "stat")
    # Second order: the penalty's gradient on ws, against jax.grad of the same.
    (g,) = torch.autograd.grad(got, wt)
    jg = jax.grad(lambda w: jloss.path_length_penalty(jfn, w, jnp.asarray(0.5), key,
                                                      jloss.SetGANLossConfig(pl_weight=2.0))[0]
                  )(jnp.asarray(ws))
    _close(g, jg, 1e-4, "d penalty / d ws")


# ------------------------------------------------------------------ modules

def _jax_vars(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(functools.partial(module.init, **kw), jax.random.PRNGKey(0),
                            *args)
    return seed_tree(shapes, seed)


def test_single_disc_matches_jax():
    x = np.random.RandomState(7).randn(3, 32, 32, 16).astype(np.float32)
    jm = jdisc.SingleDisc(start_sz=32, out_features=24)
    v = _jax_vars(jm, x, seed=1)
    port = SingleDisc(16, 32, out_features=24)
    load_jax_variables(port, v)
    _close(port(torch.from_numpy(x)), jax.jit(jm.apply)(v, x), TOL, "SingleDisc")


@pytest.mark.parametrize("pooling", ["mean", "pma", "max"])
def test_multiset_comparator_with_masks_matches_jax(pooling):
    rng = np.random.RandomState(8)
    r, x = rng.randn(2, 4, 16).astype(np.float32), rng.randn(2, 3, 16).astype(np.float32)
    rm = np.array([[True, True, False, False], [True, True, True, True]])
    xm = np.array([[True, False, False], [True, True, True]])
    jm = jdisc.MultiSetComparator(16, num_heads=4, num_blocks=2, pooling=pooling,
                                  decoder_layers=1)
    v = _jax_vars(jm, r, x, seed=2, r_mask=rm, x_mask=xm)
    port = MultiSetComparator(16, 4, 2, pooling=pooling, decoder_layers=1)
    load_jax_variables(port, v)
    args = [torch.from_numpy(a) for a in (r, x)]
    got = port(*args, r_mask=torch.from_numpy(rm), x_mask=torch.from_numpy(xm))
    want = jax.jit(lambda *a: jm.apply(*a, r_mask=rm, x_mask=xm))(v, r, x)
    _close(got, want, TOL, f"MultiSetComparator {pooling}")
    _close(port(*args), jax.jit(jm.apply)(v, r, x), TOL,
           f"MultiSetComparator {pooling}, no masks")


@pytest.mark.parametrize("backbone", ["tiny_proj", "tf_efficientnet_lite0"])
def test_feature_projector_with_and_without_remat(backbone):
    x = np.random.RandomState(9).randn(2, 64, 64, 3).astype(np.float32)
    jm = jdisc.FeatureProjector(backbone=backbone)
    v = _jax_vars(jm, x, seed=3)
    want = jax.jit(jm.apply)(v, x)
    outs = {}
    for remat in (False, True):
        port = FeatureProjector(backbone=backbone, remat=remat)
        load_jax_variables(port, v)
        port.requires_grad_(False)
        xt = torch.from_numpy(x).requires_grad_(True)
        got = port(xt)
        for k in want:
            _close(got[k], want[k], TOL, f"{backbone} remat={remat} stage {k}")
        (gx,) = torch.autograd.grad(sum(t.square().sum() for t in got.values()), xt)
        outs[remat] = gx
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def jax_disc(backbone, res):
    jm = jdisc.ProjectedSetDiscriminator(latent_size=32, num_discs=4, interp224=False,
                                         backbones=(backbone,), attn_layers=1)
    r0, c0 = jnp.zeros((1, 2, res, res, 3)), jnp.zeros((1, 1, res, res, 3))
    return jm, _jax_vars(jm, r0, c0, seed=4)


def port_disc(backbone, res, variables):
    port = ProjectedSetDiscriminator(res, latent_size=32, num_discs=4, interp224=False,
                                     backbones=(backbone,), attn_layers=1, device="cpu")
    load_jax_variables(port, variables)
    return port.eval()


def _sets(res, seed):
    r, x = _images((2, 3, res, res, 3), seed), _images((2, 2, res, res, 3), seed + 1)
    rm = np.array([[True, True, False], [True, True, True]])
    xm = np.array([[True, False], [True, True]])
    return r, x, rm, xm


@pytest.mark.parametrize("backbone,res", [("tiny_proj", 64), ("vgg16_proj", 64)])
def test_projected_set_discriminator_matches_jax(backbone, res):
    jm, v = jax_disc(backbone, res)
    port = port_disc(backbone, res, v)
    r, x, rm, xm = _sets(res, 10)
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, 4, res, res)
    # One compile: p = 1 keeps every augmented image (keep_u < 1), p = 0 none.
    jfn = jax.jit(lambda v_, r_, x_, p_: jm.apply(v_, r_, x_, rng=key, r_mask=rm, x_mask=xm,
                                                  ada_p=p_))
    with torch.no_grad():
        args = (torch.from_numpy(r), torch.from_numpy(x))
        kw = dict(r_mask=torch.from_numpy(rm), x_mask=torch.from_numpy(xm))
        for what, port_kw, p in (("augmented", dict(draws=draws), 1.0),
                                 ("ADA p 0.5", dict(draws=draws, ada_p=0.5), 0.5),
                                 ("not augmented", {}, 0.0)):
            got = port(*args, **port_kw, **kw)
            assert tuple(got.shape) == (2, 4)
            _close(got, jfn(v, r, x, jnp.float32(p)), TOL, f"{backbone} logits, {what}")
    trains = projector_param_mask(port)
    names = [n for n, _ in port.named_parameters()]
    assert trains and len(trains) < len(names)
    assert all(not n.startswith("proj_") for n in trains)
    assert all(n in trains for n in names if not n.startswith("proj_"))


def test_padded_slots_change_no_logit():
    jm, v = jax_disc("tiny_proj", 64)
    port = port_disc("tiny_proj", 64, v)
    r, x, rm, xm = _sets(64, 12)
    draws = jax_draws(jax.random.PRNGKey(2), 4, 64, 64)
    kw = dict(draws=draws, r_mask=torch.from_numpy(rm), x_mask=torch.from_numpy(xm))
    r2, x2 = r.copy(), x.copy()
    r2[0, 2] = _images((64, 64, 3), 40)
    x2[0, 1] = _images((64, 64, 3), 41)
    with torch.no_grad():
        a = port(torch.from_numpy(r), torch.from_numpy(x), **kw)
        b = port(torch.from_numpy(r2), torch.from_numpy(x2), **kw)
        unmasked = port(torch.from_numpy(r2), torch.from_numpy(x2), draws=draws)
    scale = float(a.abs().max())
    assert float((a - b).abs().max()) <= TOL * scale
    assert float((unmasked[0] - a[0]).abs().max()) > 1e-3 * scale


# ------------------------------------------------------------------ runtime utilities

def test_runtime_util_matches_jax(tmp_path, capsys):
    """`runtime.util` against the JAX package's: EasyDict, format_time,
    get_obj_by_name / construct_class_by_name, TimingUtil's bookkeeping, the
    stdout tee, and `open_url` on a local path and a ``file://`` URL (no
    network: the JAX package's, given a cache directory here, copies a
    ``file://`` URL into it)."""
    from stylegan3_editing_tpu.runtime import util as jutil
    from stylegan3_editing_tpu_torch.runtime import util

    d = util.EasyDict(a=1)
    d.b = 2
    assert d == {"a": 1, "b": 2} and d.a == 1
    del d.a
    with pytest.raises(AttributeError):
        d.a
    for sec in (0, 1.4, 59.6, 61, 3599, 3600, 86399, 86400, 200000.7):
        assert util.format_time(sec) == jutil.format_time(sec), sec
    assert util.get_obj_by_name("numpy.float32") is np.float32
    assert util.construct_class_by_name("aab", class_name="collections.Counter")["a"] == 2
    with pytest.raises(ValueError):
        util.construct_class_by_name()
    t = util.TimingUtil()
    for _ in range(2):
        with t("phase"):
            pass
    assert t.summary()["phase"]["count"] == 2 and t.mean("phase") >= 0
    log = tmp_path / "log.txt"
    logger = util.Logger(str(log))
    print("through the tee")
    logger.close()
    assert log.read_text() == "through the tee\n"
    assert "through the tee" in capsys.readouterr().out
    blob = tmp_path / "weights.bin"
    blob.write_bytes(b"\x00\x01seeded")
    with util.open_url(str(blob)) as f, jutil.open_url(
            blob.as_uri(), cache_dir=str(tmp_path / "cache"), verbose=False) as g:
        assert f.read() == g.read() == b"\x00\x01seeded"
    with util.open_url(blob.as_uri()) as f:
        assert f.read() == b"\x00\x01seeded"
    assert not (tmp_path / "downloads").exists()
