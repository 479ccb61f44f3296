"""The port's StyleCLIP CLIs (`styleclip_preprocess`, `styleclip_edit`)
against the JAX package's, on the CPU.

The port's CLIs run as processes (``python -m`` with ``--device cpu``), the
JAX CLIs' ``main`` in the test's own process meanwhile, with the same
options, from the same files: a slim SG3-R (32², 4 layers of 16 channels,
the JAX package's init with its zero leaves and EMAs seeded, as a
``.npz``), an OpenAI-format CLIP state dict saved with `torch.save` at
`test_torch_clip.WIDE12`'s widths (the JAX CLIs' `CLIP()` is given the
same widths), a BPE vocabulary written by the test, and, for the edit, a
ReStyle checkpoint in the numpy format holding that generator as its
decoder (IR-SE-50 e4e encoder, seeded; the edit CLI does not run it).

`sg3_r_config`'s policy runs every layer of so small a generator in bf16,
in both packages. So the statistics (mapping and affines only, fp32) are
held at `test_torch_styleclip.py`'s tolerances (against the JAX CLI's
files and a float64 recomputation), the edited PNGs within one
level plus `RANGE_RENDER_TOL` of max |ref| (the generator tests' bf16
image tolerance). The ``delta_i_c`` rows are unit vectors, each the
normalised difference of the CLIP features of two bf16 renders; where a
channel moves its renders little, the two packages' bf16 roundings (up to
2.2 % of the image) turn its row by many degrees. So each row is held by
its cosine with the JAX row, at least ``DELTA_BF16_COS`` = 0.9 (26°), and
must lie nearer its own JAX row than any other channel's (neighbouring
channels' rows reach cosines of ~0.96 with each other); the port CLI's
file is also held to the port's `compute_delta_i_c` on the same files,
whose fp32 parity with the JAX package is in `test_torch_styleclip.py`.
"""

import dataclasses
import gzip
import importlib.util
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.editing.styleclip_global import DEFAULT_TEMPLATES
from stylegan3_editing_tpu.models.backbones import clip as jclip
from stylegan3_editing_tpu.models.sg3 import Generator as JaxGenerator
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu.models.sg3 import convert as jconvert
from stylegan3_editing_tpu.runtime import checkpoint as jckpt
from stylegan3_editing_tpu_torch.editing.interfacegan import RANGE_RENDER_TOL
from stylegan3_editing_tpu_torch.training.options import E4eTrainOptions
from test_torch_clip import WIDE12, _learn_merges, openai_state
from test_torch_encoders import encoder_variables, generator_variables
from test_torch_styleclip import S_RTOL, exact_stats, std_tol

ROOT = Path(__file__).resolve().parents[1]
DELTA_BF16_COS = 0.9
DECODER = dict(channel_base=512, channel_max=16, num_layers=3)
SIZE = dict(stylegan_size=32, decoder_channel_base=512, decoder_channel_max=16,
            decoder_num_layers=3)


def jax_cli(name):
    """The JAX package's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    cli = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = cli  # its dataclass looks its module up there
    spec.loader.exec_module(cli)
    return cli


def _jax_styleclip_cli(name):
    cli = jax_cli(name)
    cli.CLIP = lambda: jclip.CLIP(**WIDE12)  # the widths of the test's CLIP file
    return cli


def _port_cli(name, **options):
    args = [a for k, v in options.items()
            for a in ([f"--{k}", *map(str, v)] if isinstance(v, list) else [f"--{k}", str(v)])]
    return subprocess.Popen(
        [sys.executable, "-m", f"stylegan3_editing_tpu_torch.scripts.{name}", "--device", "cpu",
         *args], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


def _wait(proc):
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    return stdout


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("styleclip_cli")
    cfg = jcfg.sg3_r_config(32, **DECODER)
    gvars = jax.tree_util.tree_map(np.asarray, generator_variables(cfg, 210))
    jconvert.variables_to_npz(gvars, str(root / "gen.npz"))
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in openai_state(211).items()},
               root / "clip.pt")
    merges = _learn_merges([t.format(p) for t in DEFAULT_TEMPLATES
                            for p in ("face", "smiling face")], 300)
    with gzip.open(root / "vocab.txt.gz", "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return root, cfg, gvars


@pytest.fixture(scope="module")
def preprocess(inputs):
    """Both stages of both CLIs: 1,100 samples (one batch of 1,024 and a
    ragged one), then ``delta_i_c`` over every channel, 8 a call."""
    root = inputs[0]
    opts = dict(generator_path=root / "gen.npz", clip_weights=root / "clip.pt",
                num_images=1100, truncation_psi=0.6, **SIZE)
    jcli = _jax_styleclip_cli("styleclip_preprocess")
    for stage in ("stats", "delta_i_c"):
        proc = _port_cli("styleclip_preprocess", stage=stage, output_path=root / "port", **opts)
        jcli.main(jcli.PreprocessOptions(stage=stage, output_path=str(root / "jax"), **{
            k: str(v) if isinstance(v, Path) else v for k, v in opts.items()}))
        _wait(proc)
    return root


def test_preprocess_cli_matches_jax(inputs, preprocess):
    root, cfg, gvars = preprocess, *inputs[1:]
    emean, estd = exact_stats(JaxGenerator(cfg), gvars, 1100, truncation_psi=0.6,
                              truncation_cutoff=8)
    assert sorted(p.name for p in (root / "jax").iterdir()) == \
        sorted(p.name for p in (root / "port").iterdir()) == ["S_1000", "delta_i_c.npy", "s_stats"]
    (jt, jmean, jstd), (t, mean, std) = (_pickle(root / d / "s_stats") for d in ("jax", "port"))
    j1k, s1k = (_pickle(root / d / "S_1000") for d in ("jax", "port"))
    assert list(mean) == list(jmean) and list(s1k) == list(j1k) == list(jmean)
    assert all(abs(t[k] - jt[k]) <= 1e-5 for k in jt)
    for k in jmean:
        s_max = float(np.abs(j1k[k]).max())
        assert np.abs(s1k[k] - j1k[k]).max() <= S_RTOL * s_max, k
        assert np.abs(mean[k] - jmean[k]).max() <= S_RTOL * s_max, k
        assert (np.abs(std[k] - estd[k]) <= std_tol(s_max, emean[k], estd[k])).all(), k
        assert (np.abs(std[k] - jstd[k]) <= std_tol(s_max, emean[k], estd[k], 1024)).all(), k
    got, ref = (np.load(root / d / "delta_i_c.npy") for d in ("port", "jax"))
    assert got.shape == ref.shape == (sum(v.shape[0] for v in jmean.values()), 32)
    cos = got @ ref.T
    print(f"cli delta_i_c: cosine with the JAX row min {np.diag(cos).min():.5f} (tol "
          f"{DELTA_BF16_COS}), median {np.median(np.diag(cos)):.5f}; with the nearest other "
          f"row max {(cos - 3 * np.eye(len(cos))).max():.4f}")
    assert np.diag(cos).min() >= DELTA_BF16_COS
    assert (cos.argmax(axis=1) == np.arange(len(cos))).all(), "a row is nearer another channel's"


def test_preprocess_cli_is_the_module_api(inputs, preprocess):
    """The port CLI's ``delta_i_c.npy`` is `compute_delta_i_c` on its own
    files, generator and CLIP (the wiring of the options), to 1e-5 (another
    thread count may sum CLIP's matmuls in another order)."""
    from stylegan3_editing_tpu_torch.editing.styleclip_global import compute_delta_i_c
    from stylegan3_editing_tpu_torch.models.backbones.clip import load_clip_weights
    from stylegan3_editing_tpu_torch.models.sg3 import Generator, load_jax_variables
    from stylegan3_editing_tpu_torch.models.sg3 import sg3_r_config
    from stylegan3_editing_tpu_torch.models.sg3.convert import npz_to_variables

    root, port = inputs[0], preprocess / "port"
    G = Generator(sg3_r_config(32, **DECODER), device="cpu")
    load_jax_variables(G, npz_to_variables(root / "gen.npz"))
    _, s_mean, s_std = _pickle(port / "s_stats")
    with torch.no_grad():
        want = compute_delta_i_c(G, load_clip_weights(root / "clip.pt", device="cpu"),
                                 _pickle(port / "S_1000"), s_mean, s_std)
    assert np.abs(np.load(port / "delta_i_c.npy") - want).max() <= 1e-5


def test_edit_cli_matches_jax(inputs, preprocess, tmp_path):
    """The same edits from the same latents, statistics (the JAX CLI's
    files) and vocabulary: 2 images × α ∈ {2, -1} × β ∈ {0.11, 0}."""
    from PIL import Image

    root, cfg, gvars = inputs
    enc = encoder_variables(50, cfg.num_ws, seed=212)
    variables = {"params": {"encoder": enc["params"], "decoder": gvars["params"]},
                 "batch_stats": {"encoder": enc["batch_stats"]},
                 "buffers": {"decoder": gvars["buffers"]}, "ema": {"decoder": gvars["ema"]}}
    opts = E4eTrainOptions(output_size=32, **{f"decoder_{k}": v for k, v in DECODER.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt.jax, "process_count", lambda: 2)  # the JAX package's numpy format
        jckpt.save_pytree(tmp_path / "ckpt", {"variables": variables},
                          {"opts": dataclasses.asdict(opts), "is_e4e": True})
    model = JaxGenerator(cfg)
    ws = np.asarray(model.apply(gvars, np.random.RandomState(213).randn(2, 512).astype(
        np.float32), truncation_psi=0.7, method=model.map))
    np.save(tmp_path / "latents.npy", {"b.png": ws[1][None], "a.png": ws[0][None]})
    opts = dict(checkpoint_path=tmp_path / "ckpt", latents_path=tmp_path / "latents.npy",
                stats_path=preprocess / "jax", clip_weights=root / "clip.pt",
                bpe_path=root / "vocab.txt.gz", alphas=[2.0, -1.0], betas=[0.11, 0.0])
    proc = _port_cli("styleclip_edit", exp_dir=tmp_path / "port", **opts)
    jcli = _jax_styleclip_cli("styleclip_edit")
    jcli.main(jcli.StyleCLIPEditOptions(exp_dir=str(tmp_path / "jax"), **{
        k: str(v) if isinstance(v, Path) else v for k, v in opts.items()}))
    _wait(proc)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 8 and names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        got, ref = (np.asarray(Image.open(tmp_path / d / name), np.float64)
                    for d in ("port", "jax"))
        tol = 1 + RANGE_RENDER_TOL * np.abs(ref - 127.5).max()
        print(f"{name}: max abs err {np.abs(got - ref).max():.0f} levels (tol {tol:.2f})")
        assert got.shape == ref.shape == (32, 32, 3) and np.abs(got - ref).max() <= tol, name
