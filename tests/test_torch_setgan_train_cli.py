"""The port's SetGAN trainer on the CPU without the JAX trainer: its float64
reference's convolution, the options it refuses, the frozen groups of the
pretrained and superres phases, NaN scrubbing, ADA, the `train_setgan` CLI
and the tick loop with an evaluation.

The tests that step the JAX trainer beside the port's are in
`test_torch_setgan_train.py`, whose helpers and slim configuration these
share; the conv check's tolerance is float64 rounding (1e-12), the rest
compare bytes, counts and flags.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch
from jax import lax

from stylegan3_editing_tpu_torch.models.sg3 import SG3Config
from stylegan3_editing_tpu_torch.runtime.checkpoint import load_pytree
from stylegan3_editing_tpu_torch.setgan import (SetGANLossConfig, SetGANTrainConfig,
                                                SetGANTrainer)
from test_torch_setgan_train import (CFG, SLIM, Z_DIM, _port_state, batch_np, conv_as_products,
                                     port_config, x64_reference)

torch.set_num_threads(1)


@pytest.mark.parametrize("lhs,rhs,strides,padding,groups,dims", [
    ((2, 9, 8, 6), (4, 4, 6, 10), (2, 2), ((1, 1), (1, 1)), 1, ("NHWC", "HWIO", "NHWC")),
    ((2, 9, 8, 6), (3, 3, 1, 6), (1, 1), "VALID", 6, ("NHWC", "HWIO", "NHWC")),
    ((2, 9, 8, 6), (3, 2, 1, 6), (2, 1), "SAME", 6, ("NHWC", "HWIO", "NHWC")),
    ((2, 6, 9, 8), (10, 6, 4, 4), (2, 2), ((1, 2), (0, 1)), 1, ("NCHW", "OIHW", "NCHW"))])
def test_conv_as_products_is_lax_conv(lhs, rhs, strides, padding, groups, dims):
    """The float64 reference's convolution is XLA's, in float64."""
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal(lhs), rng.standard_normal(rhs)
    with x64_reference():
        dn = lax.conv_dimension_numbers(x.shape, w.shape, dims)
        got = np.asarray(conv_as_products(x, w, strides, padding, dimension_numbers=dn,
                                          feature_group_count=groups))
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(lax.conv_general_dilated(x, w, strides, padding, dimension_numbers=dn,
                                                   feature_group_count=groups))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_path_length_weight_raises():
    with pytest.raises(NotImplementedError, match="path-length regularisation"):
        SetGANTrainer(SetGANTrainConfig(**CFG, loss=SetGANLossConfig(pl_weight=2.0)),
                      SG3Config(**SLIM), device="cpu")
    # A stem tree merges by name and shape: the matching leaf is carried, a
    # leaf of another shape and an unknown name are not.
    fc0 = np.random.RandomState(2).randn(Z_DIM, Z_DIM).astype(np.float32)
    stem = {"params": {"mapping": {"fc0": {"weight": fc0, "bias": np.zeros(3, np.float32)}},
                       "nope": {"weight": fc0}}}
    tr = SetGANTrainer(port_config(), SG3Config(**SLIM), device="cpu", stem_variables=stem)
    assert tr.carried == {"decoder": ["params/mapping/fc0/weight"]}
    for module in (tr.G, tr.G_ema):
        np.testing.assert_array_equal(module.decoder.mapping.fc0.weight.detach().numpy(), fc0)


@pytest.mark.parametrize("mode", ["pretrained", "head_only"])
def test_frozen_groups_stay_byte_for_byte(mode):
    """The pretrained phase (ReStyle-encoder mode, encoder and decoder frozen)
    moves the style attention only; the superres phase's head-only mode
    moves the head layers of the synthesis and nothing else of the decoder."""
    kw = (dict(restyle_mode="encoder", restyle_iters=1, freeze_encoder=True,
               freeze_decoder=True) if mode == "pretrained"
          else dict(train_head_only=True, head_layer_names=("L3_32_16", "L4_32_3")))
    tr = SetGANTrainer(port_config(**kw), SG3Config(**SLIM), device="cpu")
    before = _port_state(tr)
    tr.train_step(batch_np(4))
    after = _port_state(tr)
    moved = set()
    for k, v in after["g"].items():
        top = k.split(".")[0]
        if mode == "pretrained":
            frozen = top in ("encoder", "decoder")
        else:
            frozen = top == "decoder" and not any(f"synthesis.{h}." in k
                                                  for h in kw["head_layer_names"])
        if v.tobytes() != before["g"][k].tobytes():
            assert not frozen, (mode, k)
            moved.add(top if top != "decoder" else "decoder heads")
    # The style attention of style 0 stays: the input layer's affine starts at
    # zero, so w[0] has no gradient at the init (in both packages).
    assert moved == ({"style_attn"} if mode == "pretrained"
                     else {"encoder", "style_attn", "decoder heads"}), moved
    d_moved = {k for k, v in after["d"].items() if v.tobytes() != before["d"][k].tobytes()}
    assert d_moved and not any(k.startswith("proj_") for k in d_moved)


def test_nan_gradients_are_scrubbed():
    """A NaN in a real candidate makes D's gradient NaN; the scrub zeroes it
    and every parameter stays finite."""
    tr = SetGANTrainer(port_config(), SG3Config(**SLIM), device="cpu")
    batch = batch_np(5)
    batch["candidate"][1, 1, 3, 4, 0] = np.nan
    m = tr.train_step(batch)
    assert not math.isfinite(float(m["Loss/D/loss"]))
    for module in (tr.G, tr.D, tr.G_ema):
        assert all(torch.isfinite(p).all() for p in module.parameters())


def test_ada_moves_p_from_the_real_signs():
    tr = SetGANTrainer(port_config(ada_target=0.6, ada_interval_imgs=2, ada_kimg=0.001,
                                   augment_p=0.5), SG3Config(**SLIM), device="cpu")
    m = tr.train_step(batch_np(6))
    sign = float(m["Loss/signs/real"])
    want = float(np.clip(0.5 + np.sign(sign - 0.6) * 3 / 1.0, 0, 1))
    assert float(m["Progress/augment"]) == tr.ada.state.p == want


@pytest.fixture(scope="module")
def class_folder(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("classes")
    rng = np.random.RandomState(0)
    for c in range(3):
        (root / f"class_{c}").mkdir()
        for i in range(6):
            Image.fromarray((rng.rand(40, 40, 3) * 255).astype("uint8")).save(
                root / f"class_{c}" / f"{i}.png")
    return root


CLI_ARGS = ["--resolution", "64", "--encoder_res", "64", "--cbase", "1024", "--cmax", "32",
            "--syn_layers", "4", "--batch", "2", "--reference_min", "2", "--reference_max", "3",
            "--candidate_min", "1", "--candidate_max", "2", "--backbones", "tiny_proj",
            "--encoder_num_layers", "8", "--d_latent", "32", "--g_attn_layers", "1",
            "--d_attn_layers", "1", "--total_kimg", "0.004", "--tick_kimg", "0.002",
            "--snapshot_ticks", "1"]


def test_train_setgan_cli_on_the_cpu(class_folder, tmp_path, monkeypatch):
    """`train_setgan --device cpu --fid false` over a folder of PNGs: a stats
    line a tick, snapshots with their grids, the final snapshot restorable.
    The decoder's latents are 64 wide (the CLI's are 512, which makes the
    encoder's style heads and each snapshot some 1 GB)."""
    from stylegan3_editing_tpu_torch.scripts import train_setgan

    sg3_t_config = train_setgan.sg3_t_config
    monkeypatch.setattr(train_setgan, "sg3_t_config",
                        lambda *a, **kw: sg3_t_config(*a, **kw, z_dim=Z_DIM, w_dim=Z_DIM))
    out = tmp_path / "run"
    trainer = train_setgan.cli(["--data", str(class_folder), "--outdir", str(out),
                                "--device", "cpu", "--fid", "false", *CLI_ARGS])
    assert trainer.cur_nimg == 4 and trainer.cur_tick == 2
    lines = [json.loads(line) for line in (out / "stats.jsonl").read_text().splitlines()]
    assert [e["tick"] for e in lines] == [0, 1] and [e["kimg"] for e in lines] == [0.002, 0.004]
    for e in lines:
        assert all(math.isfinite(e[k]) for k in ("Loss/D/loss", "Loss/G/loss",
                                                 "Loss/scores/real", "Timing/Dmain"))
    assert (out / "snapshot_000000").is_dir() and (out / "fakes_000000.png").exists()
    _, meta = load_pytree(out / "final")
    assert meta["cur_nimg"] == 4 and meta["cfg"]["d_backbones"] == ["tiny_proj"]
    again = train_setgan.build_trainer(train_setgan.SetGANCliOptions(
        data=str(class_folder), outdir=str(tmp_path / "again"), device="cpu", fid=False,
        resolution=64, encoder_res=64, cbase=1024, cmax=32, syn_layers=4, batch=2,
        backbones="tiny_proj", encoder_num_layers=8, d_latent=32, g_attn_layers=1,
        d_attn_layers=1)).restore(out / "final")
    assert again.decoder_cfg.w_dim == Z_DIM
    for (n, a), b in zip(trainer.G_ema.named_parameters(), again.G_ema.parameters()):
        assert torch.equal(a, b), n


@pytest.fixture(scope="module")
def pretrained_files(tmp_path_factory):
    """What the superres and pretrained phases read, at `CLI_ARGS`' sizes
    with 64-wide latents: a stem run's snapshot at 32² (the CLI's trainer,
    not stepped), a coach checkpoint holding a ReStyle encoder (the 8-layer
    trunk with ReStyle's 6-channel first conv, seeded apart from the CLI's),
    and the 64² decoder as a reference ``.pt`` state dict."""
    from chip_smoke import reference_state
    from stylegan3_editing_tpu_torch.models.encoders import ProgressiveBackboneEncoder
    from stylegan3_editing_tpu_torch.models.sg3 import Generator, to_jax_variables
    from stylegan3_editing_tpu_torch.runtime.checkpoint import save_pytree
    from stylegan3_editing_tpu_torch.scripts import train_setgan

    root = tmp_path_factory.mktemp("pretrained")
    with pytest.MonkeyPatch.context() as mp:
        sg3_t_config = train_setgan.sg3_t_config
        mp.setattr(train_setgan, "sg3_t_config",
                   lambda *a, **kw: sg3_t_config(*a, **kw, z_dim=Z_DIM, w_dim=Z_DIM))
        opts = train_setgan.parse_dataclass(train_setgan.SetGANCliOptions, [
            "--device", "cpu", "--fid", "false", "--seed", "5", *CLI_ARGS, "--resolution", "32"])
        stem = train_setgan.build_trainer(opts)
        stem.snapshot(root / "stem")
        cfg = train_setgan.sg3_t_config(64, channel_base=1024, channel_max=32, num_layers=4)
    enc = ProgressiveBackboneEncoder(n_styles=cfg.num_ws, style_dim=Z_DIM, num_layers=8,
                                     generator=torch.Generator().manual_seed(6))
    enc_vars = to_jax_variables(enc)
    save_pytree(root / "coach", {"variables": {c: {"encoder": t} for c, t in enc_vars.items()}},
                {"opts": {}})
    gen = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    torch.save(reference_state(gen), root / "G.pt")
    return {"stem": root / "stem", "stem_trainer": stem, "coach": root / "coach",
            "enc_vars": enc_vars, "G.pt": root / "G.pt", "gen": gen}


@pytest.mark.parametrize("flags,match", [
    pytest.param(["--fid", "false", "--superres", "true"], "superres", id="flags0-slice 18"),
    pytest.param(["--fid", "false", "--encoder_path", "enc"], "encoder", id="flags1-slice 18"),
    pytest.param(["--fid", "false", "--generator_path", "G.pt"], "generator",
                 id="flags2-convert_checkpoint"),
    pytest.param(["--fid", "false", "--devices", "2"], "#10", id="flags3-#10"),
    pytest.param(["--fid", "false", "--pl_weight", "2"], "path-length regularisation",
                 id="flags4-path-length regularisation")])
def test_train_setgan_refuses_what_is_not_ported(class_folder, tmp_path, flags, match,
                                                 pretrained_files, monkeypatch):
    """``--devices 2`` and ``--pl_weight 2`` are refused before any work:
    nothing is written. The superres phase runs: ``--superres true
    --path_stem`` grows the 32² stem to 64² with 2 head layers, carries the
    mapping, the input and L0 among others (their values after a step
    still the stem's, being frozen) and trains the head layers only; ``--encoder_path``
    (a coach checkpoint) and a reference ``.pt`` ``--generator_path`` load
    into G and G_ema."""
    from stylegan3_editing_tpu_torch.models.sg3 import to_jax_variables
    from stylegan3_editing_tpu_torch.scripts import train_setgan

    out = tmp_path / "run"
    argv = ["--data", str(class_folder), "--outdir", str(out), "--device", "cpu", *flags]
    if match in ("#10", "path-length regularisation"):
        with pytest.raises(NotImplementedError, match=match):
            train_setgan.cli(argv)
        assert not out.exists()
        return
    sg3_t_config = train_setgan.sg3_t_config
    monkeypatch.setattr(train_setgan, "sg3_t_config",
                        lambda *a, **kw: sg3_t_config(*a, **kw, z_dim=Z_DIM, w_dim=Z_DIM))
    slim = [a for a in CLI_ARGS]
    slim[slim.index("--total_kimg") + 1], slim[slim.index("--snapshot_ticks") + 1] = "0.002", "9"
    if match == "superres":
        with pytest.raises(ValueError, match="--path_stem"):
            train_setgan.cli(argv + slim)
        trainer = train_setgan.cli(argv + slim + ["--path_stem", str(pretrained_files["stem"]),
                                                  "--up_factor", "2", "--head_layers", "2"])
        assert trainer.cur_nimg == 2 and trainer.decoder_cfg.img_resolution == 64
        assert trainer.cfg.train_head_only and len(trainer.cfg.head_layer_names) == 5
        carried = trainer.carried["decoder"]
        assert {"fc0", "fc1", "w_avg", "input", "L0_36_32"} <= {p.split("/")[2]
                                                                for p in carried}, carried
        stem = to_jax_variables(pretrained_files["stem_trainer"].G.decoder)
        now = to_jax_variables(trainer.G.decoder)
        for path in carried:
            if path.split("/")[2] in trainer.cfg.head_layer_names:
                continue  # a head layer of the stem's name: carried, then trained
            col, *keys = path.split("/")
            a, b = stem[col], now[col]
            for k in keys:
                a, b = a[k], b[k]
            np.testing.assert_array_equal(b, a, err_msg=path)
        trains = {n.split(".")[2] for n in trainer.g_params if n.startswith("decoder.")}
        assert trains == set(trainer.cfg.head_layer_names)
        return
    if match == "encoder":
        argv[argv.index("enc")] = str(pretrained_files["coach"])
    else:
        argv[argv.index("G.pt")] = str(pretrained_files["G.pt"])
    trainer = train_setgan.build_trainer(train_setgan.parse_dataclass(
        train_setgan.SetGANCliOptions, argv + slim))
    for module in (trainer.G, trainer.G_ema):
        if match == "encoder":
            first = "params/trunk/input_conv/kernel"
            want = _port_flat(pretrained_files["enc_vars"])
            assert sorted(trainer.carried["encoder"]) == sorted(set(want) - {first})
            assert want[first].shape[2] == 6 and module.encoder.trunk.input_conv.kernel.shape[2] == 3
            got = to_jax_variables(module.encoder)
            want = {k: v for k, v in pretrained_files["enc_vars"].items()}
        else:
            got = to_jax_variables(module.decoder)
            want = to_jax_variables(pretrained_files["gen"])
        flat_got, flat_want = _port_flat(got), _port_flat(want)
        assert flat_got.keys() == flat_want.keys()
        for k, v in flat_want.items():
            if match == "encoder" and k == first:
                continue
            np.testing.assert_array_equal(flat_got[k], v, err_msg=k)


def _port_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_port_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def test_train_ticks_run_eval_fn_and_keep_the_best(tmp_path):
    """`train` over a batch iterator: a stats line a tick, ``eval_fn`` at
    every ``eval_ticks``-th tick after the first, the best value kept; the
    metrics stay on the device between ticks."""
    seen = []
    tr = SetGANTrainer(port_config(tick_kimg=0.002, eval_ticks=1), SG3Config(**SLIM),
                       device="cpu")
    values = iter([3.0, 2.0])

    def eval_fn(trainer):
        seen.append(trainer.cur_tick)
        return next(values)

    lines = []
    tr.train(iter([batch_np(7), batch_np(8), batch_np(9)]), total_kimg=0.006, eval_fn=eval_fn,
             log_fn=lines.append)
    assert [e["tick"] for e in lines] == [0, 1, 2] and seen == [1, 2] and tr.best_fid == 2.0
    assert all(isinstance(e["Loss/G/loss"], float) for e in lines) and not tr._pending
