"""The port's ``run_pti_images`` CLI against the JAX package's, on the CPU.

The port's CLI runs as a process (``python -m`` with ``--device cpu``), and
the JAX CLI's ``main`` (``scripts/run_pti_images.py``) in the test's own
process meanwhile, with the same options, from the same files: a
slim SG3-R generator (32², 5 layers of 32 channels, the JAX package's init
with its zero leaves and EMAs seeded, written by the JAX package's
`variables_to_npz`), a ``latents.npy`` of pivots and two PNGs. Each tunes
for 2 steps, per image and with ``--shared_weights``. ``--lpips_lambda 0``
and ``--lpips_threshold 0``: the two packages' LPIPS nets come from their
own random inits (no released weights), so only the L2 term is shared
between the two CLIs, and no image converges (LPIPS parity with copied
weights is held in `test_torch_pti.py`). Both write the same files; the
tuned parameters agree within `test_torch_pti.py`'s 1e-4 and the PNGs
within one level of 255 (a 1e-4 difference can round to the next level);
the shared mode renders with the generator's bf16 policy (as the JAX CLI),
so its PNGs get the bf16 image tolerance on top.
"""

import importlib.util
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.sg3 import Generator as JaxGenerator
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu.models.sg3 import convert as jconvert
from stylegan3_editing_tpu_torch.editing.interfacegan import RANGE_RENDER_TOL
from stylegan3_editing_tpu_torch.inversion import PTI, PTIOptions
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from stylegan3_editing_tpu_torch.models.sg3.convert import npz_to_variables
from stylegan3_editing_tpu_torch.scripts import run_pti_images
from test_torch_encoders import generator_variables

ROOT = Path(__file__).resolve().parents[1]
PARAM_ATOL = 1e-4  # test_torch_pti.py's
DECODER = dict(decoder_channel_base=512, decoder_channel_max=32, decoder_num_layers=4)
JAX_OPTIONS = dict(output_size=32, steps=2, batch_size=2, lpips_lambda=0.0, lpips_threshold=0.0,
                   **DECODER)
COMMON = [str(a) for k, v in JAX_OPTIONS.items() for a in (f"--{k}", v)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("pti_inputs")
    cfg = jcfg.sg3_r_config(32, channel_base=512, channel_max=32, num_layers=4)
    variables = jax.tree_util.tree_map(np.asarray, generator_variables(cfg, seed=90))
    jconvert.variables_to_npz(variables, str(root / "gen.npz"))
    rng = np.random.RandomState(91)
    model = JaxGenerator(cfg)
    ws = np.asarray(model.apply(variables, rng.randn(2, 512).astype(np.float32),
                                method=model.map))
    (root / "images").mkdir()
    latents = {}
    for i, name in enumerate(("a.png", "b.png")):
        Image.fromarray(rng.randint(0, 256, (40, 48, 3), dtype=np.uint8)).save(
            root / "images" / name)
        pivots = ws[i] + 0.3 * rng.randn(2, *ws.shape[1:])
        latents[name] = pivots.astype(np.float32)  # [n_iters, num_ws, 512]
    np.save(root / "latents.npy", latents)
    return root, cfg, variables


PORT_CLI = [sys.executable, "-m", "stylegan3_editing_tpu_torch.scripts.run_pti_images",
            "--device", "cpu"]
MODES = ("per-image", "shared")


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_run_pti_images", ROOT / "scripts" / "run_pti_images.py")
    cli = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = cli  # its dataclass looks its module up there
    spec.loader.exec_module(cli)
    return cli


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The port's CLI as one process a mode, both started first; meanwhile
    the JAX CLI's `main` runs in this process, one thread a mode (its time
    is mostly compiles), with the same options."""
    root = inputs[0]
    out = tmp_path_factory.mktemp("pti_runs")
    paths = dict(images_path=root / "images", latents_path=root / "latents.npy",
                 generator_path=root / "gen.npz")
    procs = {}
    for mode in MODES:
        extra = ["--shared_weights", "true"] if mode == "shared" else []
        args = PORT_CLI + [a for k, v in paths.items() for a in (f"--{k}", v)] + [
            "--exp_dir", out / mode / "port", *COMMON, *extra]
        procs[mode] = subprocess.Popen(
            [str(a) for a in args], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    try:
        jcli = _jax_cli()
        with ThreadPoolExecutor(len(MODES)) as pool:
            for run in [pool.submit(jcli.main, jcli.RunPTIOptions(
                    exp_dir=str(out / mode / "jax"), shared_weights=mode == "shared",
                    **{k: str(v) for k, v in paths.items()}, **JAX_OPTIONS)) for mode in MODES]:
                run.result()
        yield out, procs
    finally:
        for proc in procs.values():
            proc.kill()
            proc.communicate()


def _wait(proc):
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    return stdout


def _files(out):
    return sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())


def _compare(out, jout, bf16):
    """PNGs within one level, or, for the shared mode's renders in the bf16
    policy, one level plus `RANGE_RENDER_TOL` of max |ref| (the generator
    tests' bf16 image tolerance); parameters within `PARAM_ATOL`."""
    from PIL import Image

    assert _files(out) == _files(jout)
    for name in ("a.png", "b.png"):
        got, ref = (np.asarray(Image.open(d / "images" / name), np.float64) for d in (out, jout))
        assert got.shape == ref.shape == (32, 32, 3)
        tol = 1 + (RANGE_RENDER_TOL * np.abs(ref - 127.5).max() if bf16 else 0)
        assert np.abs(got - ref).max() <= tol, (name, np.abs(got - ref).max(), tol)
    for model in (p for p in _files(jout) if p.endswith(".npz")):
        got, ref = np.load(out / model), np.load(jout / model)
        assert sorted(got.files) == sorted(ref.files)
        assert all(k.startswith("['synthesis_tuned']['L") for k in ref.files)
        for k in ref.files:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("mode", ["per-image", "shared"])
def test_run_pti_images_cli_matches_jax(runs, mode):
    out, procs = runs
    stdout = _wait(procs[mode])
    shared = mode == "shared"
    expect = ["images/a.png", "images/b.png"] + (
        ["pti_video_model.npz"] if shared else ["a_model.npz", "b_model.npz"])
    assert _files(out / mode / "port") == sorted(expect)
    assert ("shared-weights PTI over 2 frames" in stdout) == shared
    _compare(out / mode / "port", out / mode / "jax", bf16=shared)


def test_tune_returns_what_the_files_hold(inputs):
    """The tuning function on tensors: one tree per image, whose parameters,
    installed with `tuned_variables`, render that image's final image."""
    root, cfg, variables = inputs
    opts = run_pti_images.RunPTIOptions(output_size=32, device="cpu", **DECODER)
    G = run_pti_images.load_generator(str(root / "gen.npz"), run_pti_images.decoder_config(opts),
                                      "cpu")
    rng = np.random.RandomState(92)
    codes = torch.from_numpy(rng.randn(3, cfg.num_ws, 512).astype(np.float32))
    targets = torch.from_numpy(rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32))
    pti = PTI(G, opts=PTIOptions(steps=2, lpips_threshold=0.0))
    images, trees, log = run_pti_images.tune(pti, codes, targets, batch_size=2)
    assert images.shape == (3, 32, 32, 3) and len(trees) == 3 and len(log) == 2
    for i, tree in enumerate(trees):
        G2 = run_pti_images.load_generator(None, G.cfg, "cpu")
        load_jax_variables(G2, run_pti_images.tuned_variables(
            npz_to_variables(root / "gen.npz"), tree))
        with torch.no_grad():
            again = G2.synthesize(codes[i:i + 1], force_fp32=pti.force_fp32)
        torch.testing.assert_close(again[0], images[i], rtol=0, atol=1e-6)
    layer = sorted(trees[0])[1]
    assert not np.array_equal(trees[0][layer]["weight"], trees[1][layer]["weight"])


def test_run_pti_images_refuses_a_pickle(inputs):
    with pytest.raises(SystemExit, match="convert_checkpoint"):
        run_pti_images.load_generator("net.pkl", run_pti_images.decoder_config(
            run_pti_images.RunPTIOptions(output_size=32, **DECODER)), "cpu")
