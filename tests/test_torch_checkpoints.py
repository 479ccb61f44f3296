"""The port's reference-checkpoint readers and converters against the JAX
package's, on the CPU.

Every checkpoint is written in the test from seeded weights, in the
reference's formats: a generator's state dict (OIHW convs and the stored
``synthesis.input.transform``, the inverse of the JAX converter applied to
a JAX tree) saved as a ``.pt`` and as an official-format
``persistent_class`` pickle whose embedded source raises if it is ever run
(`chip_smoke.write_reference_pickle`, the writer phase 11 of the smoke
uses), TF1 pickles (`tests/test_converters.py`'s fakes), and malicious
pickles.
Both packages read and convert each file: the trees are equal leaf for
leaf, and the two generators' images agree within 1e-5 of max |ref| (fp32
on both sides, the convs and matmuls summing in another order).
"""

import importlib.util
import io
import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.encoders import convert as jenc_convert
from stylegan3_editing_tpu.models.sg3 import Generator as JaxGenerator
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu.models.sg3 import convert as jconvert
from stylegan3_editing_tpu.models.sg3 import persistence as jpersistence
from stylegan3_editing_tpu_torch.models.sg3 import Generator, load_jax_variables, sg3_r_config
from stylegan3_editing_tpu_torch.models.sg3 import convert, persistence
from stylegan3_editing_tpu_torch.scripts import convert_checkpoint
from chip_smoke import write_reference_pickle
from test_converters import fake_persistence_modules  # noqa: F401
from test_torch_encoders import generator_variables, irse50_reference_state

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RES = 64
SLIM = dict(channel_base=2048, channel_max=64, num_layers=6)
IMAGE_RTOL = 1e-5  # of max |ref|


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def assert_trees_equal(got, ref):
    fg, fr = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, ref))
    assert sorted(fg) == sorted(fr)
    for k in fr:
        assert fg[k].dtype == fr[k].dtype and fg[k].shape == fr[k].shape, k
        np.testing.assert_array_equal(fg[k], fr[k], err_msg=k)


def reference_state(variables, transform):
    """The reference's generator state dict for a JAX tree: dotted names,
    conv weights HWIO → OIHW, and the stored user transform."""
    state = {}
    for coll in ("params", "buffers", "ema"):
        for name, v in _flat(variables[coll]).items():
            name = name.replace("/", ".")
            state[name] = v.transpose(3, 2, 0, 1) if name.endswith(".weight") and v.ndim == 4 \
                else v
    state["synthesis.input.transform"] = transform
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


@pytest.fixture(scope="module")
def source():
    """A seeded slim SG3-R generator in the JAX package's tree, its config,
    and its state dict in the reference's naming."""
    cfg = jcfg.sg3_r_config(RES, **SLIM)
    variables = jax.tree_util.tree_map(np.asarray, generator_variables(cfg, seed=60))
    transform = np.random.RandomState(61).randn(3, 3).astype(np.float32)
    return cfg, variables, transform, reference_state(variables, transform)


def _images(cfg, jvars, tvars):
    ws = np.random.RandomState(62).randn(2, cfg.num_ws, cfg.w_dim).astype(np.float32)
    jmodel = JaxGenerator(cfg)
    ref = np.asarray(jax.jit(lambda v, w: jmodel.apply(v, w, force_fp32=True,
                                                       method=jmodel.synthesize))(jvars, ws))
    gen = Generator(sg3_r_config(RES, **SLIM), device="cpu")
    load_jax_variables(gen, tvars)
    with torch.no_grad():
        got = gen.synthesize(torch.from_numpy(ws), force_fp32=True).numpy()
    err = float(np.abs(got - ref).max())
    print(f"image: max abs err {err:.3g}, max |ref| {float(np.abs(ref).max()):.3g}")
    assert got.shape == ref.shape and err <= IMAGE_RTOL * float(np.abs(ref).max())


def test_pt_state_dict_converts_as_in_jax(source, tmp_path):
    """A ``.pt`` state dict: the trees equal the JAX converter's and the
    source tree, the stored transform comes back, and the images agree."""
    cfg, variables, transform, state = source
    torch.save(state, tmp_path / "gen.pt")
    torch.save({"state_dict": state}, tmp_path / "wrapped.pt")
    tcfg = sg3_r_config(RES, **SLIM)
    got, got_t = convert.load_torch_pt(tmp_path / "gen.pt", tcfg)
    ref, ref_t = jconvert.load_torch_pt(str(tmp_path / "gen.pt"), cfg)
    assert_trees_equal(got, ref)
    assert_trees_equal(got, variables)
    np.testing.assert_array_equal(got_t, ref_t)
    np.testing.assert_array_equal(got_t, transform)
    assert_trees_equal(convert.load_torch_pt(tmp_path / "wrapped.pt", tcfg)[0], ref)
    _images(cfg, ref, got)


def test_persistent_pickle_converts_as_in_jax(source, tmp_path):
    """An official-format pickle: read without running its embedded source,
    its stubs' state dicts equal in both packages, and the trees equal."""
    cfg, variables, transform, state = source
    write_reference_pickle(tmp_path / "net.pkl", state, cfg)
    data = persistence.load_network_pkl(tmp_path / "net.pkl")
    jdata = jpersistence.load_network_pkl(tmp_path / "net.pkl")
    g = data["G_ema"]
    assert isinstance(g, persistence.PersistentStub) and g.class_name == "Generator"
    assert dict(g.init_kwargs) == dict(jdata["G_ema"].init_kwargs)
    sd, jsd = persistence.state_dict_of(g), jpersistence.state_dict_of(jdata["G_ema"])
    assert sorted(sd) == sorted(jsd) == sorted(state)
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    got, got_t = convert.load_pkl(tmp_path / "net.pkl", sg3_r_config(RES, **SLIM))
    ref, _ = jconvert.load_pkl(str(tmp_path / "net.pkl"), cfg)
    assert_trees_equal(got, ref)
    np.testing.assert_array_equal(got_t, transform)
    _images(cfg, ref, got)


def test_converter_refuses_a_foreign_or_mismatched_state(source):
    cfg, _, _, state = source
    tcfg = sg3_r_config(RES, **SLIM)
    for bad, match in (({**state, "synthesis.extra.weight": torch.zeros(1)}, "unmatched"),
                       ({k: v for k, v in state.items() if k != "mapping.w_avg"}, "missing")):
        with pytest.raises(ValueError, match=match):
            convert.torch_state_to_variables(bad, tcfg)
        with pytest.raises(ValueError, match=match):
            jconvert.torch_state_to_variables({k: v.numpy() for k, v in bad.items()}, cfg)
    wide = sg3_r_config(RES, z_dim=256, **SLIM)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.torch_state_to_variables(state, wide)
    loose, _ = convert.torch_state_to_variables(
        {**state, "synthesis.extra.weight": torch.zeros(1)}, tcfg, strict=False)
    assert "extra" not in loose["params"]["synthesis"]


def _tf_network(rng, lod_torgb):
    import dnnlib.tflib.network as n

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    variables = [("dlatent_avg", arr(8)), ("mapping/Dense0/weight", arr(8, 8)),
                 ("mapping/Dense0/bias", arr(8)),
                 ("synthesis/4x4/Const/const", arr(1, 16, 4, 4)),
                 ("synthesis/4x4/Conv/weight", arr(3, 3, 16, 16)),
                 ("synthesis/4x4/Conv/bias", arr(16)),
                 ("synthesis/4x4/Conv/mod_weight", arr(8, 16)),
                 ("synthesis/4x4/Conv/mod_bias", arr(16)),
                 ("synthesis/4x4/Conv/noise_strength", np.float32(0.5)),
                 ("synthesis/noise0", arr(1, 1, 4, 4)),
                 ("synthesis/8x8/Conv0_up/weight", arr(3, 3, 16, 16)),
                 ("synthesis/8x8/Conv0_up/bias", arr(16)),
                 ("synthesis/8x8/Conv0_up/mod_weight", arr(8, 16)),
                 ("synthesis/8x8/Conv0_up/mod_bias", arr(16)),
                 ("synthesis/8x8/Skip/weight", arr(1, 1, 16, 16))]
    rgb = "ToRGB_lod1" if lod_torgb else "synthesis/8x8/ToRGB"
    variables += [(f"{rgb}/weight", arr(1, 1, 16, 3)), (f"{rgb}/bias", arr(3)),
                  (f"{rgb}/mod_weight", arr(8, 16)), (f"{rgb}/mod_bias", arr(16))]
    obj = n.Network.__new__(n.Network)
    obj.__dict__.update({"version": 4, "name": "G",
                         "static_kwargs": {"latent_size": 8, "dlatent_size": 8,
                                           "resolution": 8},
                         "components": {}, "variables": variables})
    return obj


@pytest.mark.parametrize("lod_torgb", [False, True], ids=["torgb", "lod-torgb"])
def test_tf1_pickle_reads_as_in_jax(tmp_path, fake_persistence_modules, lod_torgb):
    """A TF1 (G, D, Gs) triple: the legacy conversion gives the same
    networks_stylegan2 state dicts in both packages (Dense transposes,
    HWIO → OIHW, flipped up-convs, mod_bias + 1, ToRGB_lod remapped first)."""
    rng = np.random.RandomState(63)
    with open(tmp_path / "tf.pkl", "wb") as f:
        pickle.dump(tuple(_tf_network(rng, lod_torgb) for _ in range(3)), f)
    got = persistence.load_network_pkl(tmp_path / "tf.pkl")
    ref = jpersistence.load_network_pkl(str(tmp_path / "tf.pkl"))
    assert sorted(got) == sorted(ref) == ["D", "G", "G_ema"]
    for entry in ("G", "D", "G_ema"):
        assert sorted(got[entry]) == sorted(ref[entry])
        for k in ref[entry]:
            np.testing.assert_array_equal(got[entry][k], ref[entry][k], err_msg=k)
    torgb = "synthesis.b4.torgb.weight" if lod_torgb else "synthesis.b8.torgb.weight"
    assert torgb in got["G_ema"] and got["G_ema"]["synthesis.b8.skip.weight"].shape == \
        (16, 16, 1, 1)


class _System:
    def __reduce__(self):
        import os
        return os.system, ("true",)


class _Eval:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return eval, (f"open({str(self.marker)!r}, 'w').close()",)


class _Exec(_Eval):
    def __reduce__(self):
        return exec, (f"open({str(self.marker)!r}, 'w').close()",)


class _Getattr:
    def __reduce__(self):
        return getattr, ("x", "upper")


@pytest.mark.parametrize("kind", ["os.system", "eval", "exec", "getattr"])
def test_malicious_pickles_are_refused_by_both(tmp_path, kind):
    marker = tmp_path / "ran"
    evil = {"os.system": _System(), "eval": _Eval(marker), "exec": _Exec(marker),
            "getattr": _Getattr()}[kind]
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"G_ema": evil}, f)
    for reader in (persistence.load_network_pkl, jpersistence.load_network_pkl):
        with pytest.raises(pickle.UnpicklingError, match="not allowlisted"):
            reader(path)
    assert not marker.exists()


def test_tensor_storage_bytes_cannot_run_code(tmp_path):
    """A tensor's storage bytes are read by torch's weights-only unpickler:
    bytes that hold a pickled call are refused, where the reference's
    ``torch.storage._load_from_bytes`` would run it. Real storages still load."""
    marker = tmp_path / "ran"

    class Storage:
        def __reduce__(self):
            from torch.storage import _load_from_bytes
            return _load_from_bytes, (pickle.dumps(_Eval(marker)),)

    with open(tmp_path / "evil.pkl", "wb") as f:
        pickle.dump({"G_ema": Storage()}, f)
    with pytest.raises(pickle.UnpicklingError):
        persistence.load_network_pkl(tmp_path / "evil.pkl")
    assert not marker.exists()
    t = torch.randn(3, 4)
    data = persistence.load_network_pkl(io.BytesIO(pickle.dumps({"G_ema": {"w": t}})))
    assert torch.equal(data["G_ema"]["w"], t)


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_checkpoint", ROOT / "scripts" / "convert_checkpoint.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


def _same_outputs(dst, jdst):
    """The same ``.npz`` keys and arrays, and the JAX CLI's JSON fields."""
    got, ref = np.load(f"{dst}.npz"), np.load(f"{jdst}.npz")
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    meta, jmeta = (json.loads(Path(f"{p}.json").read_text()) for p in (dst, jdst))
    if "decoder_cfg" in jmeta:  # `remat` is an option of the JAX package alone
        jmeta["decoder_cfg"].pop("remat", None)
    assert {k: meta[k] for k in jmeta if k != "src"} == {k: v for k, v in jmeta.items()
                                                         if k != "src"}
    return meta


def test_convert_checkpoint_cli_matches_jax(source, tmp_path):
    """`convert_checkpoint --kind auto` on a ``.pkl`` (config from the
    pickle's init kwargs) and on a ``.pt`` (config from the preset and
    overrides): the same files as the JAX CLI's, and each loads into a port
    `Generator` equal to the source tree."""
    cfg, variables, transform, state = source
    write_reference_pickle(tmp_path / "net.pkl", state, cfg)
    torch.save(state, tmp_path / "gen.pt")
    jcli = _jax_cli()
    for src, kw in (("net.pkl", {}), ("gen.pt", dict(res=RES, cfg_overrides=dict(SLIM)))):
        dst, jdst = tmp_path / f"port_{src}", tmp_path / f"jax_{src}"
        convert_checkpoint.convert(str(tmp_path / src), str(dst), **kw)
        jcli.convert(str(tmp_path / src), str(jdst), **kw)
        meta = _same_outputs(dst, jdst)
        assert meta["kind"] == "sg3" and meta["decoder_cfg"]["num_layers"] == 6
        np.testing.assert_array_equal(np.asarray(meta["transform"], np.float32), transform)
        gen = Generator(sg3_r_config(RES, **SLIM), device="cpu")
        load_jax_variables(gen, convert.npz_to_variables(f"{dst}.npz"))
        for name, value in gen.state_dict().items():
            want = reference_state(variables, transform)[name].numpy()
            want = want.transpose(2, 3, 1, 0) if want.ndim == 4 else want
            np.testing.assert_array_equal(value.numpy(), want, err_msg=name)


def test_convert_checkpoint_cli_encoder_matches_jax(source, tmp_path):
    """`--kind encoder` on a full ReStyle e4e checkpoint (``encoder.*`` and
    ``decoder.*`` keys and its options): the JAX CLI's ``.npz``/``.json``,
    and a numpy-format checkpoint that `load_encoder` reads with its own
    decoder or with a generator swapped in."""
    from stylegan3_editing_tpu_torch.utils.inference_utils import load_encoder

    cfg, variables, _, gen_state = source
    state = irse50_reference_state(n_styles=cfg.num_ws, seed=64)
    ckpt = {"state_dict": {**{f"encoder.{k}": torch.from_numpy(np.asarray(v))
                              for k, v in state.items()},
                           **{f"decoder.{k}": v for k, v in gen_state.items()}},
            "opts": {"encoder_type": "ProgressiveBackboneEncoder", "input_nc": 6,
                     "output_size": RES, "learning_rate": 1e-4}}
    torch.save(ckpt, tmp_path / "restyle.pt")
    meta = convert_checkpoint.convert(str(tmp_path / "restyle.pt"), str(tmp_path / "enc"),
                                      kind="encoder", cfg_overrides=SLIM)
    _jax_cli().convert(str(tmp_path / "restyle.pt"), str(tmp_path / "jenc"), kind="encoder")
    assert _same_outputs(tmp_path / "enc", tmp_path / "jenc") == json.loads(
        (tmp_path / "enc.json").read_text())
    assert meta["kind"] == "encoder" and meta["encoder"]["n_styles"] == cfg.num_ws
    want, _ = jenc_convert.convert_restyle_encoder_state(state)
    other = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.5, variables)
    for swap, gvars in ((None, variables), (other, other)):
        model, opts = load_encoder(meta["checkpoint"], generator_variables=swap, device="cpu")
        assert opts.encoder_type == "ProgressiveBackboneEncoder" and model.is_progressive
        assert opts.learning_rate == 1e-4 and opts.decoder_num_layers == SLIM["num_layers"]
        assert torch.equal(model.encoder.trunk.body_23.se.fc2.kernel, torch.from_numpy(
            np.asarray(want["params"]["trunk"]["body_23"]["se"]["fc2"]["kernel"])))
        np.testing.assert_array_equal(model.decoder.mapping.w_avg.numpy(),
                                      gvars["ema"]["mapping"]["w_avg"])


@pytest.mark.parametrize("kind", [pytest.param("sg2_stem", id="sg2_stem-#9"),
                                  pytest.param("backbone", id="backbone-#9"),
                                  pytest.param("class_embedding", id="class_embedding-#9")])
def test_convert_checkpoint_names_what_the_other_kinds_wait_for(tmp_path, kind):
    """The kinds that came with SetGAN's stems and growth: an SG2 stem state
    dict in the reference's naming, a torchvision RegNetX-200MF state dict
    (``--name regnetx_002``) and a pickled ``{"embed": nn.Embedding}``
    convert to the JAX CLI's files, each tree equal to its source."""
    from stylegan3_editing_tpu_torch.models.backbones import registry
    from stylegan3_editing_tpu_torch.models.sg2_stem import SG2Config
    from test_torch_feature_registry_convert import torch_state
    from test_torch_sg2_stem import SLIM as SG2_SLIM
    from test_torch_sg2_stem import sg2_reference_state

    kw = {}
    if kind == "sg2_stem":
        overrides = {k: v for k, v in SG2_SLIM.items() if k != "img_resolution"}
        state = sg2_reference_state(SG2Config(**SG2_SLIM, use_bf16=False))
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
                   tmp_path / "src.pt")
        src, kw = "src.pt", dict(res=SG2_SLIM["img_resolution"], cfg_overrides=overrides)
    elif kind == "backbone":
        port, _ = registry.make_feature_network("regnetx_002",
                                                generator=torch.Generator().manual_seed(1))
        state = torch_state("regnetx_002", port)
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, tmp_path / "src.pt")
        src, kw = "src.pt", dict(name="regnetx_002")
    else:
        emb = torch.nn.Embedding(10, 6)
        with torch.no_grad():
            emb.weight.copy_(torch.from_numpy(np.random.RandomState(3).randn(10, 6)))
        with open(tmp_path / "src.pkl", "wb") as f:
            pickle.dump({"embed": emb}, f)
        src = "src.pkl"
    meta = convert_checkpoint.convert(str(tmp_path / src), str(tmp_path / "port"), kind=kind,
                                      **kw)
    _jax_cli().convert(str(tmp_path / src), str(tmp_path / "jax"), kind=kind, **kw)
    assert _same_outputs(tmp_path / "port", tmp_path / "jax") == meta and meta["kind"] == kind
    got = convert.npz_to_variables(tmp_path / "port.npz")
    if kind == "sg2_stem":
        np.testing.assert_array_equal(got["params"]["b8"]["conv0"]["weight"],
                                      state["synthesis.b8.conv0.weight"].transpose(2, 3, 1, 0))
        np.testing.assert_array_equal(got["ema"]["mapping"]["w_avg"], state["mapping.w_avg"])
    elif kind == "backbone":
        net, _ = registry.make_feature_network("regnetx_002")
        load_jax_variables(net, got)
        assert sum(v.size for v in state.values()) == sum(
            t.numel() for t in net.state_dict().values())
    else:
        np.testing.assert_array_equal(got["class_embedding"], emb.weight.detach().numpy())
        assert meta["shape"] == [10, 6]


def test_convert_checkpoint_runs_as_a_module(source, tmp_path):
    """``python -m`` with a JSON ``--cfg``: a ``.pt`` converts on the CPU."""
    cfg, variables, _, state = source
    torch.save(state, tmp_path / "gen.pt")
    out = subprocess.run(
        [sys.executable, "-m", "stylegan3_editing_tpu_torch.scripts.convert_checkpoint",
         "--src", tmp_path / "gen.pt", "--dst", tmp_path / "gen", "--res", str(RES),
         "--cfg", json.dumps(SLIM)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "wrote" in out.stdout
    assert_trees_equal(convert.npz_to_variables(tmp_path / "gen.npz"), variables)
