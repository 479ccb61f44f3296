"""The port's checkpoints, encoder loading, data pipeline and the two
inference CLIs, against the JAX package, on the CPU.

The checkpoint is a ReStyle-e4e coach checkpoint in the numpy format
(``arrays.npz`` + ``sg3tpu_manifest.json`` and the ``<dir>.json`` sidecar
with the options), written in the test: an IR-SE-50 encoder at its full
depth with seeded leaves in the JAX package's tree (`encoder_variables` of
`test_torch_encoders.py`) and the JAX package's init of a small SG3-R
decoder (64², 5 layers of 64 channels, named by the options'
``decoder_*`` overrides). Codes are held at 1e-4 of max |ref| (IR-SE-50's
53 convs sum in another order in XLA and PyTorch, about 1e-7 relative a
sum); trees and files, exactly.

The CLIs run as ``python -m`` with ``--device cpu`` on two 40×48 PNGs.
Their ``latents.npy`` is held against the port's module API on the same
images (the API is held against the JAX package here and in
`test_torch_encoders.py`) within 1e-5 of max |ref|: one process against
another, the same code.
"""

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.data import ImagesDataset as JImagesDataset
from stylegan3_editing_tpu.data import encode_transforms as jencode_transforms
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu.models.sg3 import convert as jconvert
from stylegan3_editing_tpu.runtime import checkpoint as jckpt
from stylegan3_editing_tpu.utils import inference_utils as jinference
from stylegan3_editing_tpu_torch.data import BatchIterator, ImagesDataset, encode_transforms
from stylegan3_editing_tpu_torch.editing import FaceEditor
from stylegan3_editing_tpu_torch.models.encoders import (RestyleNet, get_average_image,
                                                         run_restyle_iterations)
from stylegan3_editing_tpu_torch.models.sg3 import Generator, load_jax_variables, sg3_r_config
from stylegan3_editing_tpu_torch.models.sg3.convert import npz_to_variables, variables_to_npz
from stylegan3_editing_tpu_torch.runtime.checkpoint import load_pytree, save_pytree
from stylegan3_editing_tpu_torch.scripts import inference_editing, inference_iterative
from stylegan3_editing_tpu_torch.training.options import E4eTrainOptions, TrainOptions
from stylegan3_editing_tpu_torch.utils.inference_utils import load_encoder
from test_torch_encoders import encoder_variables, generator_variables

ROOT = Path(__file__).resolve().parents[1]
CODES_TOL = 1e-4
CLI_TOL = 1e-5
DECODER = dict(channel_base=1024, channel_max=64, num_layers=4)
OPTS = dict(output_size=64, decoder_channel_base=1024, decoder_channel_max=64,
            decoder_num_layers=4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A ReStyle-e4e coach checkpoint in the numpy format, as the JAX
    package writes it from a multi-process run, and its variables."""
    n_styles = sg3_r_config(64, **DECODER).num_ws
    enc = encoder_variables(50, n_styles, seed=50)
    gen = generator_variables(jcfg.sg3_r_config(64, **DECODER), seed=51)
    variables = {"params": {"encoder": enc["params"], "decoder": gen["params"]},
                 "batch_stats": {"encoder": enc["batch_stats"]},
                 "buffers": {"decoder": gen["buffers"]}, "ema": {"decoder": gen["ema"]}}
    opts = E4eTrainOptions(**OPTS)
    path = tmp_path_factory.mktemp("ckpt") / "iteration_0"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt.jax, "process_count", lambda: 2)  # the JAX package's numpy format
        jckpt.save_pytree(path, {"variables": variables, "step": np.asarray(7)},
                          {"opts": dataclasses.asdict(opts), "is_e4e": True})
    assert (path / "sg3tpu_manifest.json").exists()
    return path, variables


def test_pytree_round_trips_between_the_packages(checkpoint, tmp_path):
    """The port reads the JAX package's numpy checkpoints leaf for leaf, and
    the JAX package reads the port's."""
    path, variables = checkpoint
    tree, meta = load_pytree(path)
    assert_trees_equal(tree["variables"], variables)
    assert int(tree["step"]) == 7 and meta["is_e4e"] is True
    assert meta["opts"]["encoder_type"] == "ProgressiveBackboneEncoder"
    small = {"a": {"b": torch.arange(6.0).reshape(2, 3)}, "c": [np.ones(2), np.zeros(1)],
             "d": None}
    save_pytree(tmp_path / "port", small, {"k": 1})
    back, meta = jckpt.load_pytree(tmp_path / "port")
    assert meta == {"k": 1} and back["d"] is None
    np.testing.assert_array_equal(back["a"]["b"], small["a"]["b"].numpy())
    np.testing.assert_array_equal(back["c"][1], np.zeros(1))


def test_load_pytree_refuses_an_orbax_checkpoint(tmp_path):
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        load_pytree(tmp_path / "orbax")


def test_load_encoder_matches_jax(checkpoint, api):
    """`load_encoder` rebuilds the e4e options and the IR-SE-50 model in
    both packages; the same input gives the same codes."""
    path, _ = checkpoint
    model, opts, _ = api
    jmodel, jvars, jopts = jinference.load_encoder(path)
    assert opts == E4eTrainOptions(**OPTS) and dataclasses.asdict(opts) == \
        dataclasses.asdict(jopts)
    assert model.is_progressive and model.n_styles == jmodel.n_styles == 6
    x = np.random.RandomState(52).randn(1, 256, 256, 6).astype(np.float32)
    avg = np.asarray(jvars["ema"]["decoder"]["mapping"]["w_avg"])
    ref = jax.jit(functools.partial(jmodel.apply, method=jmodel.encode))(jvars, x,
                                                                         latent_avg=avg)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x), latent_avg=model.decoder.mapping.w_avg)
    err = float(np.abs(got.numpy() - np.asarray(ref)).max())
    print(f"codes: max abs err {err:.3g}, max |ref| {float(np.abs(ref).max()):.3g}")
    assert err <= CODES_TOL * float(np.abs(ref).max())


def test_load_encoder_swaps_the_generator(checkpoint):
    """``generator_variables`` replaces the decoder's collections, as in the
    JAX package."""
    path, variables = checkpoint
    other = {c: jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.5, variables[c]["decoder"])
             for c in ("params", "buffers", "ema")}
    model, _ = load_encoder(path, generator_variables=other, device="cpu")
    _, jvars, _ = jinference.load_encoder(path, generator_variables=other)
    ref = Generator(sg3_r_config(64, **DECODER), device="cpu")
    load_jax_variables(ref, {c: jvars[c]["decoder"] for c in ("params", "buffers", "ema")})
    state = model.decoder.state_dict()
    for name, value in ref.state_dict().items():
        assert torch.equal(state[name], value), name


def test_npz_variables_round_trip(tmp_path):
    """`variables_to_npz` / `npz_to_variables` use the JAX package's keys:
    either package reads the other's file, and the tree fills a generator."""
    cfg = jcfg.sg3_r_config(64, **DECODER)
    variables = jax.tree_util.tree_map(np.asarray, generator_variables(cfg, seed=54))
    variables_to_npz(variables, tmp_path / "port.npz")
    jconvert.variables_to_npz(variables, str(tmp_path / "jax.npz"))
    assert sorted(np.load(tmp_path / "port.npz").files) == \
        sorted(np.load(tmp_path / "jax.npz").files)
    assert_trees_equal(npz_to_variables(tmp_path / "jax.npz"), variables)
    back = jconvert.npz_to_variables(str(tmp_path / "port.npz"))
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, back), variables)
    gen = Generator(sg3_r_config(64, **DECODER), device="cpu")
    load_jax_variables(gen, npz_to_variables(tmp_path / "port.npz"))
    np.testing.assert_array_equal(gen.mapping.w_avg.numpy(), variables["ema"]["mapping"]["w_avg"])


@pytest.fixture(scope="module")
def faces(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("faces")
    rng = np.random.RandomState(55)
    for name in ("a.png", "b.png"):
        Image.fromarray(rng.randint(0, 256, (40, 48, 3), dtype=np.uint8)).save(root / name)
    return root


def test_images_dataset_matches_jax(faces):
    """The inference transform (256² bilinear, [-1, 1]) and the pairs."""
    t, jt = encode_transforms()["transform_inference"], jencode_transforms()["transform_inference"]
    got, ref = ImagesDataset(faces, faces, target_transform=t), JImagesDataset(
        faces, faces, target_transform=jt)
    assert [p.name for p in got.source_paths] == ["a.png", "b.png"]
    for i in range(2):
        for a, b in zip(got[i], ref[i]):
            assert a.shape == (256, 256, 3) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    (x, y), = list(BatchIterator(got, 2, shuffle=False).epoch_batches())
    assert x.shape == (2, 256, 256, 3) and np.array_equal(x, y)


def _cli(module, *args):
    out = subprocess.run([sys.executable, "-m", f"stylegan3_editing_tpu_torch.scripts.{module}",
                          "--device", "cpu", *map(str, args)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def api(checkpoint, faces):
    """The module API on the CLIs' batch: the model from `load_encoder`, and
    two ReStyle iterations from the average image."""
    model, opts = load_encoder(checkpoint[0], device="cpu")
    t = encode_transforms()["transform_inference"]
    (x, _), = list(BatchIterator(ImagesDataset(faces, faces, target_transform=t), 2,
                                 shuffle=False).epoch_batches())
    with torch.no_grad():
        avg, lat = get_average_image(model)
        results = run_restyle_iterations(model, torch.from_numpy(x), avg, lat, n_iters=2)
    return model, opts, results


def test_inference_iterative_cli(checkpoint, faces, api, tmp_path):
    """Per-step images, latents.npy (name → [n_iters, n_styles, 512]) and
    stats.txt, as the JAX CLI writes them; the latents are the module API's."""
    path, _ = checkpoint
    stdout = _cli("inference_iterative", "--checkpoint_path", path, "--data_path", faces,
                  "--exp_dir", tmp_path, "--n_iters_per_batch", 2)
    assert "inverted 2 images on cpu" in stdout
    for step in (0, 1):
        assert sorted(p.name for p in (tmp_path / "inference_results" / f"step_{step}")
                      .iterdir()) == ["a.png", "b.png"]
    latents = np.load(tmp_path / "latents.npy", allow_pickle=True).item()
    stats = json.loads((tmp_path / "stats.txt").read_text())
    assert stats["batches"] == 1 and stats["mean_per_batch_s"] > 0
    results = api[2]
    for bi, name in enumerate(("a.png", "b.png")):
        ref = np.stack([codes[bi].numpy() for _, _, codes in results])
        assert latents[name].shape == (2, 6, 512)
        err = float(np.abs(latents[name] - ref).max())
        assert err <= CLI_TOL * float(np.abs(ref).max()), err


def test_inference_editing_cli(checkpoint, faces, api, tmp_path):
    """``editing_results/<direction>/<image>/<factor>.jpg`` for each boundary
    file found; a direction without one is skipped. The factor-0 render is
    the decoder's image of the inverted codes."""
    path, _ = checkpoint
    rng = np.random.RandomState(56)
    bdir = tmp_path / "boundaries"
    bdir.mkdir()
    for name in ("age", "smile"):
        d = rng.randn(1, 512).astype(np.float32)
        np.save(bdir / f"{name}_boundary.npy", d / np.linalg.norm(d))
    stdout = _cli("inference_editing", "--checkpoint_path", path, "--data_path", faces,
                  "--exp_dir", tmp_path / "out", "--boundaries_dir", bdir,
                  "--edit_directions", "age", "smile", "pose", "--factor_range", 1,
                  "--n_iters_per_batch", 1)
    assert "skipping pose: no boundary file" in stdout
    for direction in ("age", "smile"):
        for stem in ("a", "b"):
            files = sorted(p.name for p in (tmp_path / "out" / "editing_results" / direction /
                                            stem).iterdir())
            assert files == ["-1.jpg", "0.jpg", "1.jpg"]
    model, _, results = api
    editor = FaceEditor(model.decoder, boundaries_dir=bdir)
    with torch.no_grad():
        images, _ = editor.edit(results[0][2], "age", factor_range=(0, 1))
        plain = model.decoder.synthesize(results[0][2])
    torch.testing.assert_close(images[0], plain, atol=0, rtol=0)


@pytest.mark.parametrize("main", [inference_iterative.main, inference_editing.main],
                         ids=["inference_iterative", "inference_editing"])
def test_clis_refuse_to_run_without_a_card(monkeypatch, checkpoint, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--checkpoint_path", str(checkpoint[0])])


def test_entry_points_refuse_to_run_without_a_card(monkeypatch, checkpoint):
    """RestyleNet, load_encoder and the editor's generator raise with no
    card and no ``device="cpu"``: nothing runs quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = sg3_r_config(64, **DECODER)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RestyleNet(cfg, "ProgressiveBackboneEncoder", n_styles=cfg.num_ws)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_encoder(checkpoint[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FaceEditor(Generator(cfg), directions={})
    assert TrainOptions().encoder_type == "BackboneEncoder"
