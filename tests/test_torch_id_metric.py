"""The port's face-preparation and ID-metric CLIs (`prepare_faces_parallel`,
`calc_id_loss_parallel`) against the JAX package's, both in this process, on
PNGs in ``tmp_path``, on the CPU.

dlib and its model are absent: `get_dlib_detector` is replaced in both
packages by `test_torch_video_cli`'s fake (68 landmarks from the image's
colours), with an empty module standing in for ``dlib`` where it is
imported; the worker pool is a thread pool of one (so both packages meet
the images, and numpy's global random state for the crops' shifts, in the
same order). The ID metric's IR-101 runs on the 8-layer IR trunk in both
packages (their `IRSEBackbone` and `convert_irse_state` given
``num_layers=8``), read from a reference-format state dict the test writes
(``.pth``); the MTCNN protocol reads ``.npy`` files written as
`test_torch_mtcnn.py` writes them.

Tolerances: aligned and cropped faces equal (the same numpy, PIL and scipy
operations); the similarities within 1e-5 (cosines of unit fp32
embeddings, 8 layers deep); the counts and the files equal.
"""

import json
import multiprocessing.pool
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan3_editing_tpu.models.backbones import irse as jirse
from stylegan3_editing_tpu.utils import alignment_utils as jau
from stylegan3_editing_tpu_torch.models.backbones import irse
from stylegan3_editing_tpu_torch.scripts import calc_id_loss_parallel, prepare_faces_parallel
from stylegan3_editing_tpu_torch.utils import alignment_utils as au
from test_torch_encoders import init_module
from test_torch_mtcnn import _release_files
from test_torch_styleclip_cli import jax_cli
from test_torch_video import frame
from test_torch_video_cli import _fake_dlib

torch.set_num_threads(1)

SIM_ATOL = 1e-5


@pytest.fixture
def fake_dlib(monkeypatch):
    for mod in (au, jau):
        monkeypatch.setattr(mod, "get_dlib_detector", _fake_dlib)
    monkeypatch.setitem(sys.modules, "dlib", types.ModuleType("dlib"))
    monkeypatch.setattr(multiprocessing, "Pool", lambda n: multiprocessing.pool.ThreadPool(1))


def _write_images(root, seeds, size):
    root.mkdir(parents=True)
    for s in seeds:
        frame(s, size).save(root / f"{s:03d}.png")


# ------------------------------------------------------------ face preparation

@pytest.mark.parametrize("mode,shift", [("align", 0.05), ("crop", 0.0), ("crop", 0.05)],
                         ids=["align", "crop", "crop-shifted"])
def test_prepare_faces_matches_jax(mode, shift, fake_dlib, tmp_path, capsys):
    _write_images(tmp_path / "raw", (1, 2, 3, 4), (160, 128))
    (tmp_path / "raw" / "notes.txt").write_text("not an image")
    cli = jax_cli("prepare_faces_parallel")
    outputs = {}
    for name, run in (("jax", lambda o: cli.run(cli.PrepareOptions(**o))),
                      ("port", lambda o: prepare_faces_parallel.main(
                          [f"--{k}={v}" for k, v in o.items()]))):
        np.random.seed(5)
        run(dict(mode=mode, root_path=str(tmp_path / "raw"), random_shift=shift,
                 output_path=str(tmp_path / name), num_workers=2, output_size=64))
        outputs[name] = sorted(capsys.readouterr().out.splitlines())
    assert outputs["port"] == outputs["jax"] == [f"ok {s:03d}.png" for s in (1, 2, 3, 4)]
    for s in (1, 2, 3, 4):
        got, ref = (np.asarray(Image.open(tmp_path / n / f"{s:03d}.png")) for n in ("port", "jax"))
        assert got.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------------- ID metric

def irse_torch_state(variables, num_layers):
    """A reference-format IR(-SE) state dict (``input_layer.*``, ``body.N.*``,
    ``output_layer.*``) holding ``variables``, the inverse of
    `convert_irse_state`."""
    p, s = variables["params"], variables["batch_stats"]
    out = {}

    def conv(name, kernel):
        out[name] = np.transpose(kernel, (3, 2, 0, 1))

    def bn(prefix, params, stats):
        if params is not None:
            out[f"{prefix}.weight"], out[f"{prefix}.bias"] = params["scale"], params["bias"]
        out[f"{prefix}.running_mean"], out[f"{prefix}.running_var"] = stats["mean"], stats["var"]

    conv("input_layer.0.weight", p["input_conv"]["kernel"])
    bn("input_layer.1", p["input_bn"], s["input_bn"])
    out["input_layer.2.weight"] = p["input_prelu"]["alpha"]
    for idx, spec in enumerate(irse._block_specs(num_layers)):
        blk, bs, t = p[f"body_{idx}"], s[f"body_{idx}"], f"body.{idx}"
        if spec.in_channel != spec.depth:
            conv(f"{t}.shortcut_layer.0.weight", blk["shortcut_conv"]["kernel"])
            bn(f"{t}.shortcut_layer.1", blk["shortcut_bn"], bs["shortcut_bn"])
        bn(f"{t}.res_layer.0", blk["bn1"], bs["bn1"])
        conv(f"{t}.res_layer.1.weight", blk["conv1"]["kernel"])
        out[f"{t}.res_layer.2.weight"] = blk["prelu"]["alpha"]
        conv(f"{t}.res_layer.3.weight", blk["conv2"]["kernel"])
        bn(f"{t}.res_layer.4", blk["bn2"], bs["bn2"])
    bn("output_layer.0", p["output_bn"], s["output_bn"])
    out["output_layer.3.weight"] = np.asarray(p["output_linear"]["kernel"]).T
    out["output_layer.3.bias"] = p["output_linear"]["bias"]
    bn("output_layer.4", p.get("output_bn1d"), s["output_bn1d"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def _eight_layers(fn):
    return lambda *args, **kwargs: fn(*args, **{**kwargs, "num_layers": 8})


@pytest.fixture(scope="module")
def id_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("id_metric")
    for step in ("step_0", "step_1"):
        _write_images(root / "out" / step, (11, 12, 13), (256, 256))
    _write_images(root / "gt", (11, 12, 13), (200, 220))
    # The MTCNN protocol on small images (the JAX detector runs op by op over
    # each image's scale pyramid) in one folder without step_* folders.
    _write_images(root / "small", (11, 12), (96, 96))
    _write_images(root / "small_gt", (11, 12), (96, 96))
    jnet = jirse.IRSEBackbone(input_size=112, num_layers=8, mode="ir", drop_ratio=0.4,
                              affine=False)
    variables = init_module(jnet, np.zeros((1, 112, 112, 3), np.float32), seed=41)
    torch.save(irse_torch_state(variables, 8), root / "cf.pth")
    (root / "mtcnn").mkdir()
    _release_files(root / "mtcnn", 16)
    return root


def _id_runs(root, mtcnn_dir, capsys):
    cli = jax_cli("calc_id_loss_parallel")
    images = "small" if mtcnn_dir.exists() else "out"
    options = dict(gt_path=str(root / ("small_gt" if images == "small" else "gt")), batch_size=2,
                   curricular_face_path=str(root / "cf.pth"),
                   **{f"mtcnn_{n}": str(mtcnn_dir / f"{n}.npy") for n in ("pnet", "rnet", "onet")})
    results, printed = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, module in ((cli, jirse), (calc_id_loss_parallel, irse)):
            mp.setattr(mod, "IRSEBackbone", _eight_layers(module.IRSEBackbone))
            mp.setattr(mod, "convert_irse_state", _eight_layers(module.convert_irse_state))
        for name in ("jax", "port"):
            out = root / f"{name}_{mtcnn_dir.name}" / "faces"
            if not out.exists():
                shutil.copytree(root / images, out)
            if name == "jax":
                results[name] = cli.run(cli.IDLossCalcOptions(output_path=str(out), **options))
            else:
                results[name] = calc_id_loss_parallel.main(
                    [f"--{k}={v}" for k, v in options.items()]
                    + [f"--output_path={out}", "--device", "cpu"])
            printed[name] = capsys.readouterr().out
            assert json.loads((out / "id_scores.json").read_text()) == results[name]
    return results, printed


@pytest.mark.parametrize("protocol", ["centre-crop", "mtcnn"])
def test_calc_id_loss_matches_jax(id_inputs, protocol, capsys):
    """The centre-crop protocol when the MTCNN files are absent (with the JAX
    package's warning), on every ``step_*`` folder in batches of 2 (the last
    one short); MTCNN alignment when they exist, on a folder of images."""
    mtcnn_dir = id_inputs / ("mtcnn" if protocol == "mtcnn" else "absent")
    results, printed = _id_runs(id_inputs, mtcnn_dir, capsys)
    got, ref = results["port"], results["jax"]
    assert set(got) == set(ref) == ({"step_0", "step_1"} if protocol == "centre-crop"
                                    else {"faces"})
    for step in ref:
        assert got[step]["n"] == ref[step]["n"]
        for k in ("mean", "std"):
            np.testing.assert_allclose(got[step][k], ref[step][k], rtol=0, atol=SIM_ATOL)
    warned = [("MTCNN weights not found" in printed[n]) for n in ("jax", "port")]
    assert warned == [protocol == "centre-crop"] * 2
    if protocol == "centre-crop":
        assert all(ref[s]["n"] == 3 for s in ref)
    else:
        assert sum(ref[s]["n"] for s in ref) > 0, "the seeded MTCNN aligns no face"
        skipped = [sorted(line for line in printed[n].splitlines() if "skipping" in line)
                   for n in ("jax", "port")]
        assert skipped[0] == skipped[1]


def test_calc_id_loss_reads_its_weights_without_running_code(id_inputs, tmp_path):
    """The CurricularFace file is read with ``weights_only=True``: a pickle
    that would run code is refused."""
    class Boom:
        def __reduce__(self):
            return (print, ("ran",))

    torch.save({"x": Boom()}, tmp_path / "bad.pth")
    opts = calc_id_loss_parallel.IDLossCalcOptions(curricular_face_path=str(tmp_path / "bad.pth"))
    with pytest.raises(Exception, match="[Ww]eights only"):
        calc_id_loss_parallel.build_facenet(opts, torch.device("cpu"))
