"""Parity of the port's StyleCLIP global directions and its two CLIs with the
JAX package's, on the CPU.

The generator is a slimmer one than the JAX editing tests' (32², 3 layers
of 8 channels, fp32: a StyleSpace of 28 channels, so that the JAX
package's ``delta_i_c`` sweep, ~0.1 s a rendered image on the CPU, stays
short), its weights the JAX package's init with the zero leaves and EMAs
seeded (`generator_variables`); CLIP is the tiny one of
`test_torch_clip.py` (`clip_variables`). Tolerances:
- StyleSpace samples and their means: 1e-5 of the layer's max |s| (the
  mapping's 8 fp32 layers and the affine sum in another order);
- stds, per channel, against a float64 two-pass recomputation from the
  same samples (`exact_stats`): that, plus what both packages' formula
  ``sqrt(E[x²] − float32(mean)²)`` rounds (2⁻²⁴ of mean², over 2·std, and
  2⁻²⁴ of std for the cast). The JAX package sums each batch in float32
  row by row (numpy's reduction over axis 0), up to batch·2⁻²⁴ of E[x²]
  off, which ``E[x²] − mean²`` cancels down to the variance: on a channel
  with |mean| ≫ std (the input transform's cos θ) its std moves by tens of
  percent, so against the JAX package's std that bound is added;
- ``delta_i_c`` rows and Δs (unit vectors and their β-thresholded,
  max-normalised products): 1e-4 absolute; CLIP features agree to 1e-5 of
  their norm, and a row is the normalised difference of two of them;
- images: 1e-4 absolute, as in the generator tests.
The CLIs are held in `test_torch_styleclip_cli.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.editing import styleclip_global as jsc
from stylegan3_editing_tpu.models.backbones import clip as jclip
from stylegan3_editing_tpu.models.sg3 import Generator as JaxGenerator
from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu_torch.editing import styleclip_global as sc
from stylegan3_editing_tpu_torch.models.backbones import clip
from stylegan3_editing_tpu_torch.models.sg3 import Generator, SG3Config, load_jax_variables
from stylegan3_editing_tpu_torch.models.sg3 import sg3_r_config
from test_torch_clip import TINY as CLIP_TINY
from test_torch_clip import _learn_merges, clip_variables
from test_torch_encoders import generator_variables

torch.set_num_threads(1)

S_RTOL = 1e-5
DELTA_ATOL = 1e-4
IMAGE_ATOL = 1e-4
SLIM = dict(img_resolution=32, channel_base=256, channel_max=8, num_layers=2, num_critical=1,
            use_bf16=False)


@pytest.fixture(scope="module")
def models():
    jgen = JaxGenerator(JSG3Config(**SLIM))
    gvars = generator_variables(JSG3Config(**SLIM), seed=200)
    gen = Generator(SG3Config(**SLIM), device="cpu")
    load_jax_variables(gen, gvars)
    jclip_model = jclip.CLIP(**CLIP_TINY)
    cvars = clip_variables(jclip_model, 201)
    clip_model = clip.CLIP(**CLIP_TINY, device="cpu")
    load_jax_variables(clip_model, cvars)
    return jgen, gvars, gen, jclip_model, cvars, clip_model


@pytest.fixture(scope="module")
def stats(models):
    jgen, gvars, gen = models[:3]
    kw = dict(num_images=1200, batch=512, truncation_psi=0.7, truncation_cutoff=3, seed=5)
    return jsc.compute_s_statistics(jgen, gvars, **kw), sc.compute_s_statistics(gen, **kw)


def _close(got, ref, tol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    err = np.abs(got - ref)
    print(f"{what}: max abs err {float(err.max()):.3g} (tol {float(np.min(tol)):.3g})")
    assert got.shape == ref.shape and bool((err <= tol).all()), what


def std_tol(s_max, mean, std, jax_batch=0):
    """Of a std against the exact one; with ``jax_batch``, against the JAX
    package's, whose float32 batch sums are added."""
    mean, std = np.asarray(mean, np.float64), np.asarray(std, np.float64)
    second = np.square(mean) + np.square(std)
    return (S_RTOL * s_max + 2.0 ** -24 * (std + (np.square(mean) + jax_batch * second)
                                           / (2 * std)))


def exact_stats(jgen, gvars, num_images, seed=0, **kw):
    """Float64 two-pass mean and std of the samples both packages draw
    (numpy's ``RandomState(seed)`` z, mapped and W2S'd by the JAX package)."""
    z = np.random.RandomState(seed).randn(num_images, 512).astype(np.float32)
    s = jax.jit(lambda v, z: jgen.apply(v, jgen.apply(v, z, **kw, method=jgen.map),
                                        method=jgen.w2s))(gvars, z)
    s = {k: np.asarray(v, np.float64) for k, v in s.items()}
    return ({k: v.mean(0) for k, v in s.items()},
            {k: np.sqrt(np.square(v - v.mean(0)).mean(0)) for k, v in s.items()})


def test_s_statistics_match_jax(models, stats):
    """transform, s_mean, s_std and S_1000 (1,200 samples in batches of 512:
    the first 1,000 run over two batches), in the JAX package's key order."""
    (jt, jmean, jstd, j1k), (t, mean, std, s1k) = stats
    emean, estd = exact_stats(*models[:2], 1200, seed=5, truncation_psi=0.7,
                              truncation_cutoff=3)
    assert list(mean) == list(jmean) == list(std) == list(s1k) == list(j1k)
    assert list(mean) == sorted(mean) and list(mean)[-1] == "input"
    for k in ("theta", "x", "y"):
        assert abs(t[k] - jt[k]) <= 1e-5, k
    for k in jmean:
        s_max = float(np.abs(j1k[k]).max())
        assert s1k[k].shape == (1000, jmean[k].shape[0]) and s1k[k].dtype == np.float32
        _close(s1k[k], j1k[k], S_RTOL * s_max, f"S_1000 {k}")
        _close(mean[k], jmean[k], S_RTOL * s_max, f"s_mean {k}")
        _close(mean[k], emean[k], S_RTOL * s_max, f"s_mean {k} vs float64")
        _close(std[k], estd[k], std_tol(s_max, emean[k], estd[k]), f"s_std {k} vs float64")
        _close(std[k], jstd[k], std_tol(s_max, emean[k], estd[k], 512), f"s_std {k}")


def test_s_key_order_at_1024_is_the_jax_packages():
    """At SG3-R 1024 the JAX package's jitted ``w2s`` hands its dict back
    sorted (L0, L10…L14, L1…L9, input: 16 groups, 9,894 channels); the
    port's eager ``w2s`` gives input, L0…L14, and `s_key_order` maps it."""
    cfg = jcfg.sg3_r_config(1024)
    jgen = JaxGenerator(cfg)
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.zeros((1, 512)))
    jout = jax.eval_shape(jax.jit(lambda v, w: jgen.apply(v, w, method=jgen.w2s)), shapes,
                          jax.ShapeDtypeStruct((1, cfg.num_ws, 512), jnp.float32))
    gen = Generator(sg3_r_config(1024), device="cpu")
    with torch.no_grad():
        s = gen.w2s(torch.zeros((1, cfg.num_ws, 512)))
    assert list(s)[:2] == ["input", "L0_36_1024"]
    assert sc.s_key_order(s) == list(jout)
    assert list(jout)[:3] == ["L0_36_1024", "L10_1044_161", "L11_1044_102"]
    assert len(jout) == 16 and sum(v.shape[-1] for v in jout.values()) == 9894
    assert {k: tuple(v.shape) for k, v in s.items()} == {k: v.shape for k, v in jout.items()}


@pytest.fixture(scope="module")
def delta_i_c(models, stats):
    """The JAX test's reduced S (`tests/test_editing.py`): the first sample."""
    jgen, gvars, gen, jclip_model, cvars, clip_model = models
    _, jmean, jstd, j1k = stats[0]
    small = {k: v[:1] for k, v in j1k.items()}
    ref = jsc.compute_delta_i_c(jgen, gvars, jclip_model, cvars, small, jmean, jstd,
                                channels_per_batch=4)
    got = sc.compute_delta_i_c(gen, clip_model, small, jmean, jstd, channels_per_batch=4)
    return small, got, ref


def test_compute_delta_i_c_matches_jax(delta_i_c):
    small, got, ref = delta_i_c
    assert got.shape == ref.shape == (sum(v.shape[-1] for v in small.values()), 32)
    assert got.dtype == np.float32
    _close(got, ref, DELTA_ATOL, "delta_i_c")
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_delta_i_c_batch_is_a_run_of_compute_delta_i_c(models, stats, delta_i_c):
    """The per-batch function gives the rows of its channels, in order: the
    second batch of 4 of the second group, bit for bit (a batch of other
    channels would differ in the last bits: the style RMS is taken over the
    batch)."""
    gen, clip_model = models[2], models[5]
    _, jmean, jstd, _ = stats[0]
    small, got, _ = delta_i_c
    keys = list(small)
    offset = small[keys[0]].shape[-1]
    base = {k: torch.from_numpy(v) for k, v in small.items()}
    rows = sc.delta_i_c_batch(gen, clip_model, base, jmean, jstd, keys[1], [4, 5, 6, 7])
    _close(rows, got[offset + 4:offset + 8], 0, "delta_i_c_batch")


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    import gzip

    path = tmp_path_factory.mktemp("bpe") / "vocab.txt.gz"
    merges = _learn_merges([t.format(p) for t in jsc.DEFAULT_TEMPLATES
                            for p in ("face", "smiling face", "old face")], 300)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return clip.SimpleTokenizer(str(path)), jclip.SimpleTokenizer(str(path))


def test_get_delta_s_and_edit_match_jax(models, stats, tokenizers):
    """A real (small) BPE vocabulary through the templates, ``get_delta_s``
    at a β that no |r_c| lies near (some channels below it, zeroed), then
    `apply_delta_s` and the edited render from `w2s` of mapped latents."""
    jgen, gvars, gen, jclip_model, cvars, clip_model = models
    _, jmean, jstd, _ = stats[0]
    tok, jtok = tokenizers
    rng = np.random.RandomState(202)
    n = sum(v.shape[0] for v in jmean.values())
    d_ic = rng.randn(n, 32).astype(np.float32)
    d_ic /= np.linalg.norm(d_ic, axis=-1, keepdims=True)
    avg = {k: v[None] for k, v in jmean.items()}
    jgd = jsc.StyleCLIPGlobalDirection(d_ic, jstd, jsc.DEFAULT_TEMPLATES, avg, jclip_model,
                                       cvars, jtok)
    gd = sc.StyleCLIPGlobalDirection(d_ic, jstd, sc.DEFAULT_TEMPLATES, avg, clip_model, tok)
    _close(gd.get_delta_i(["smiling face", "face"]), jgd.get_delta_i(["smiling face", "face"]),
           1e-5, "delta_i")
    # β in the widest gap between the lower half's |r_c|, so that a rounding
    # of r_c cannot move a channel across it.
    a = np.sort(np.abs(d_ic @ np.asarray(jgd.get_delta_i(["smiling face", "face"]))))
    i = int(np.argmax(np.diff(a[:len(a) // 2])))
    beta = float(a[i] + a[i + 1]) / 2
    assert a[i + 1] - a[i] > 1e-3
    ref = jgd.get_delta_s("face", "smiling face", beta)
    got = gd.get_delta_s("face", "smiling face", beta)
    assert list(got) == list(ref) == list(jmean)
    for k in ref:
        _close(got[k] / torch.from_numpy(jstd[k]), np.asarray(ref[k]) / jstd[k], DELTA_ATOL,
               f"delta_s {k}")

    z = rng.randn(2, 512).astype(np.float32)
    ws = jgen.apply(gvars, z, method=jgen.map)
    j_all = jgen.apply(gvars, ws, method=jgen.w2s)
    jimg = jgen.apply(gvars, None, all_s=jsc.apply_delta_s(j_all, ref, 2.0),
                      method=jgen.synthesize)
    with torch.no_grad():
        all_s = gen.w2s(torch.from_numpy(np.array(ws)))
        edited = sc.apply_delta_s(all_s, got, 2.0)
        img = gen.synthesize(None, all_s=edited)
        base = gen.synthesize(None, all_s=all_s)
    assert edited["input"] is all_s["input"]
    _close(img, jimg, IMAGE_ATOL, "edited image")
    assert float((img - base).abs().max()) > 100 * IMAGE_ATOL
