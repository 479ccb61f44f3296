"""The port's evaluation CLIs against the JAX package's, on the CPU:
`calc_losses_on_images`, `create_inversion_animation` and the port's half
of `eval_inversion_fidelity`.

- `calc_losses_on_images`: both CLIs (the JAX one as a module, in this
  process) score two ``step_*`` directories of seeded PNGs against one
  ground-truth directory in each mode, LPIPS from one seeded tree written
  as an ``.npz``; the JSON files' means agree to 1e-5 relative (per-image
  LPIPS and MS-SSIM in fp32, summed in another order) and their stds to
  1e-5 of the mean.
- `create_inversion_animation`: one e4e coach checkpoint in the numpy
  format (a seeded 8-layer IR-SE encoder and a slim SG3-R 64² decoder, 3
  layers of 16 channels, the JAX package's init seeded), three latents and
  their landmarks transforms; both CLIs render in fp32 (`sg3_r_config`
  patched to ``use_bf16=False`` in both packages, so a frame is one
  rounding of the same image) and their PNG frames agree to one level.
  The JAX CLI's `lerp` broadcasts the frame weights against the style
  axis, so the multi-frame runs give it the port's `lerp` (its own runs at
  one frame a pair).
- `eval_inversion_fidelity`: a reference-format SG3-R 64² generator state
  (`chip_smoke.reference_state`) and IR-SE-50 e4e encoder state
  (`chip_smoke.irse_reference_state`: seeded, non-trivial batch norms)
  through the port's half and through the JAX package's converters,
  ReStyle loop and LPIPS on the same targets: reconstructions within 2e-4 of max |ref| (RestyleNet's image tolerance),
  LPIPS per image within 1e-4 relative. The reference half needs the
  reference repository's checkout and skips without it.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from stylegan3_editing_tpu.criteria import lpips as jlpips
from stylegan3_editing_tpu.models.encoders import convert as jenc_convert
from stylegan3_editing_tpu.models.encoders import restyle as jrestyle
from stylegan3_editing_tpu.models.sg3 import Generator as JGenerator
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu.models.sg3 import convert as jconvert
from stylegan3_editing_tpu.runtime import checkpoint as jckpt
from stylegan3_editing_tpu.utils import inference_utils as jinference
from stylegan3_editing_tpu_torch.criteria import LPIPS
from stylegan3_editing_tpu_torch.models.encoders import restyle as trestyle
from stylegan3_editing_tpu_torch.models.sg3 import Generator, load_jax_variables, sg3_r_config
from stylegan3_editing_tpu_torch.models.sg3.convert import variables_to_npz
from stylegan3_editing_tpu_torch.scripts import (calc_losses_on_images,
                                                 create_inversion_animation,
                                                 eval_inversion_fidelity)
from stylegan3_editing_tpu_torch.training.options import E4eTrainOptions
from stylegan3_editing_tpu_torch.utils import inference_utils as tinference
from test_torch_encoders import ENCODERS, encoder_variables, generator_variables
from test_torch_eval_criteria import _lpips_variables
from test_torch_styleclip_cli import jax_cli

torch.set_num_threads(1)

SCORE_RTOL = 1e-5
IMAGE_TOL = 2e-4
LPIPS_RTOL = 1e-4
DECODER = dict(channel_base=1024, channel_max=16, num_layers=3)


def _png(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


# ------------------------------------------------------ calc_losses_on_images

@pytest.fixture(scope="module")
def score_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("scores")
    rng = np.random.RandomState(0)
    names = [f"{i}.png" for i in range(5)]
    for n in names:
        gt = rng.randint(0, 256, (40, 48, 3), dtype=np.uint8)
        _png(root / "gt" / n, gt)
        for step, noise in (("step_1", 60), ("step_2", 20)):
            out = np.clip(gt + rng.randint(-noise, noise + 1, gt.shape), 0, 255).astype(np.uint8)
            _png(root / "out" / step / n, out)
    variables = _lpips_variables("alex", np.zeros((1, 256, 256, 3), np.float32), seed=3)
    variables_to_npz(variables, root / "lpips.npz")
    return root


@pytest.mark.parametrize("mode", ["lpips", "l2", "msssim"])
def test_calc_losses_on_images_matches_jax(score_dirs, mode):
    root = score_dirs
    common = dict(mode=mode, output_path=str(root / "out"), gt_path=str(root / "gt"),
                  batch_size=2, lpips_variables=str(root / "lpips.npz"))
    jcli = jax_cli("calc_losses_on_images")
    want = jcli.run(jcli.LossCalcOptions(**common))
    want_file = json.loads((root / "out" / f"{mode}_scores.json").read_text())
    got = calc_losses_on_images.main([f"--{k}={v}" for k, v in common.items()] +
                                     ["--device", "cpu"])
    got_file = json.loads((root / "out" / f"{mode}_scores.json").read_text())
    assert want == want_file and got == got_file
    assert sorted(got) == sorted(want) == ["step_1", "step_2"]
    for step in want:
        assert got[step]["n"] == want[step]["n"] == 5
        np.testing.assert_allclose(got[step]["mean"], want[step]["mean"], rtol=SCORE_RTOL)
        # The std of scores that agree to SCORE_RTOL agrees to that of their scale.
        np.testing.assert_allclose(got[step]["std"], want[step]["std"], rtol=0,
                                   atol=SCORE_RTOL * abs(want[step]["mean"]))
    assert got["step_1"]["mean"] != got["step_2"]["mean"]


def test_calc_losses_metric_is_per_image(score_dirs):
    """`make_metric` scores each pair alone: a batch gives each image's
    batch-1 score."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(np.tanh(rng.randn(3, 64, 64, 3)).astype(np.float32))
    b = torch.from_numpy(np.tanh(rng.randn(3, 64, 64, 3)).astype(np.float32))
    for mode in calc_losses_on_images.MODES:
        metric = calc_losses_on_images.make_metric(mode, "cpu",
                                                   str(score_dirs / "lpips.npz"))
        with torch.no_grad():
            batch = metric(a, b)
            single = torch.cat([metric(a[i:i + 1], b[i:i + 1]) for i in range(3)])
        assert batch.shape == (3,)
        torch.testing.assert_close(batch, single, rtol=1e-6, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        calc_losses_on_images.make_metric("psnr", "cpu")


# ------------------------------------------------- create_inversion_animation

@pytest.fixture(scope="module")
def animation_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("animation")
    cfg = jcfg.sg3_r_config(64, use_bf16=False, **DECODER)
    enc = encoder_variables(8, cfg.num_ws, seed=61)
    gen = generator_variables(cfg, seed=62)
    variables = {"params": {"encoder": enc["params"], "decoder": gen["params"]},
                 "batch_stats": {"encoder": enc["batch_stats"]},
                 "buffers": {"decoder": gen["buffers"]}, "ema": {"decoder": gen["ema"]}}
    opts = E4eTrainOptions(output_size=64, **{f"decoder_{k}": v for k, v in DECODER.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt.jax, "process_count", lambda: 2)  # the JAX package's numpy format
        jckpt.save_pytree(root / "ckpt", {"variables": variables},
                          {"opts": dataclasses.asdict(opts), "is_e4e": True})
    rng = np.random.RandomState(63)
    w_avg = gen["ema"]["mapping"]["w_avg"]
    latents = {f"face_{i}": (w_avg + 0.5 * rng.randn(2, cfg.num_ws, 512)).astype(np.float32)
               for i in range(3)}
    np.save(root / "latents.npy", latents, allow_pickle=True)
    transforms = {}
    for i, name in enumerate(latents):
        angle = (i - 1) * 0.2
        t = np.array([[np.cos(angle), np.sin(angle), 0.05 * i],
                      [-np.sin(angle), np.cos(angle), -0.03 * i], [0, 0, 1]], np.float32)
        transforms[name] = np.stack([np.eye(3, dtype=np.float32), t])
    np.save(root / "transforms.npy", transforms, allow_pickle=True)
    return root


def _frames(out):
    files = sorted((out / "animation_frames").glob("*.png"))
    return np.stack([np.asarray(Image.open(p)) for p in files]) if files else None


@pytest.mark.parametrize("frames,transforms", [(5, False), (5, True), (1, True)],
                         ids=["lerp", "lerp_transforms", "one_frame"])
def test_create_inversion_animation_matches_jax(animation_inputs, tmp_path, frames,
                                                transforms):
    root = animation_inputs
    common = dict(checkpoint_path=str(root / "ckpt"), latents_path=str(root / "latents.npy"),
                  n_transition_frames=frames, batch_size=3,
                  landmarks_transforms_path=str(root / "transforms.npy") if transforms else None)
    jcli = jax_cli("create_inversion_animation")
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jinference, tinference):
            mp.setattr(mod, "sg3_r_config", functools.partial(mod.sg3_r_config, use_bf16=False))
        mp.setitem(trestyle.ENCODER_TYPES, "ProgressiveBackboneEncoder",
                   functools.partial(ENCODERS["ProgressiveBackboneEncoder"][1], num_layers=8))
        if frames > 1:
            mp.setattr(jcli, "lerp", create_inversion_animation.lerp)
        jcli.run(jcli.AnimationOptions(exp_dir=str(tmp_path / "jax"), **common))
        got = create_inversion_animation.run(create_inversion_animation.AnimationOptions(
            exp_dir=str(tmp_path / "port"), device="cpu", **common))
    want = _frames(tmp_path / "jax")
    assert want is not None and want.shape == (2 * frames, 64, 64, 3)
    written = _frames(tmp_path / "port")
    assert np.array_equal(written, np.stack(got))
    diff = np.abs(written.astype(int) - want.astype(int))
    print(f"frames {want.shape}: max level difference {diff.max()}")
    assert diff.max() <= 1
    assert not np.array_equal(want[0], want[-1])


def test_lerp_runs_along_the_frame_axis():
    a, b = np.zeros((4, 8), np.float32), np.ones((4, 8), np.float32)
    ts = np.linspace(0, 1, 5, dtype=np.float32)
    out = create_inversion_animation.lerp(a, b, ts)
    assert out.shape == (5, 4, 8) and np.allclose(out[:, 0, 0], ts)


# ---------------------------------------------------- eval_inversion_fidelity

FIDELITY_CFG = dict(use_bf16=False, **DECODER)


@pytest.fixture(scope="module")
def fidelity_states():
    cfg = sg3_r_config(64, **FIDELITY_CFG)
    G = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(70))
    with torch.no_grad():
        z = torch.randn((64, cfg.z_dim), generator=torch.Generator().manual_seed(71))
        G.mapping.w_avg.copy_(G.map(z)[:, 0].mean(0))
    gen_state = {k: v.numpy() for k, v in chip_smoke.reference_state(G).items()}
    enc_state = {k: v.numpy() for k, v in chip_smoke.irse_reference_state(cfg.num_ws, 72).items()}
    return cfg, gen_state, enc_state


def test_eval_inversion_fidelity_port_half_matches_jax(fidelity_states):
    cfg, gen_state, enc_state = fidelity_states
    fid = eval_inversion_fidelity
    model = fid.port_restyle_from_states(gen_state, enc_state, cfg, device="cpu")
    targets = fid.synthesize_targets(model, 2, seed=0)
    recon, avg_image, latent_avg = fid.invert(model, targets, n_iters=2)

    # The JAX package's steps of its CLI, on the same states and targets.
    jc = jcfg.sg3_r_config(64, **FIDELITY_CFG)
    gen_vars, _ = jconvert.torch_state_to_variables(gen_state, jc)
    enc_vars, info = jenc_convert.convert_restyle_encoder_state(enc_state)
    assert info["n_styles"] == cfg.num_ws
    variables = {"params": {"encoder": enc_vars["params"], "decoder": gen_vars["params"]},
                 "batch_stats": {"encoder": enc_vars["batch_stats"]},
                 "buffers": {"decoder": gen_vars["buffers"]}, "ema": {"decoder": gen_vars["ema"]}}
    jmodel = jrestyle.RestyleNet(decoder_cfg=jc, encoder_type="ProgressiveBackboneEncoder",
                                 n_styles=jc.num_ws, input_nc=6)
    z = torch.randn((2, cfg.z_dim), generator=torch.Generator().manual_seed(1)).numpy()
    full = JGenerator(jc).apply(gen_vars, jnp.asarray(z), truncation_psi=0.7)
    from stylegan3_editing_tpu.ops.image import adaptive_avg_pool2d as jpool
    want_targets = np.asarray(jpool(full, 256))
    np.testing.assert_allclose(targets.numpy(), want_targets, rtol=0,
                               atol=IMAGE_TOL * np.abs(want_targets).max())
    j_avg, j_lat = jax.jit(lambda v: jrestyle.get_average_image(jmodel, v))(variables)
    j_res = jax.jit(lambda v, x, a, la: jrestyle.run_restyle_iterations(
        jmodel, v, x, a, la, n_iters=2))(variables, targets.numpy(), j_avg, j_lat)
    want = np.asarray(j_res[-1][0])
    np.testing.assert_allclose(avg_image.numpy(), np.asarray(j_avg), rtol=0,
                               atol=IMAGE_TOL * np.abs(np.asarray(j_avg)).max())
    np.testing.assert_allclose(recon.numpy(), want, rtol=0, atol=IMAGE_TOL * np.abs(want).max())

    lp_vars = _lpips_variables("alex", want_targets, seed=73)
    jl = jlpips.LPIPS(net_type="alex")
    want_lp = [float(jl.apply(lp_vars, want[i:i + 1], targets.numpy()[i:i + 1]))
               for i in range(2)]
    lpips = LPIPS("alex", device="cpu")
    load_jax_variables(lpips, lp_vars)
    got_lp = fid.lpips_per_image(lpips, recon, targets)
    np.testing.assert_allclose(got_lp, want_lp, rtol=LPIPS_RTOL)

    record = fid.fidelity_record(float(np.mean(got_lp)), float(np.mean(want_lp)),
                                 recon.numpy(), want, 2, 64,
                                 {"encoder": False, "generator": False, "lpips_heads": False})
    assert list(record) == ["metric", "lpips_ours", "lpips_ref", "lpips_delta", "bar", "pass",
                            "recon_max_abs_diff", "num_images", "n_iters", "resolution",
                            "weights"]  # the JAX CLI's record
    assert record["pass"] is True and record["num_images"] == 2
    assert record["recon_max_abs_diff"] <= IMAGE_TOL * np.abs(want).max()


def test_eval_inversion_fidelity_needs_the_reference_checkout(tmp_path):
    for argv in (["--device", "cpu"],
                 ["--device", "cpu", "--reference_root", str(tmp_path / "missing")]):
        with pytest.raises(FileNotFoundError, match="reference_root"):
            eval_inversion_fidelity.main(argv)


def _reference_root():
    """The JAX CLI's checkout of the reference repository, where it exists."""
    root = jax_cli("eval_inversion_fidelity").REF
    return root if os.path.isdir(os.path.join(root, "models", "stylegan3")) else None


def test_eval_inversion_fidelity_reference_half(fidelity_states):
    """The reference's torch modules and the port on one seed: the CLI's
    record passes the bar."""
    root = _reference_root()
    if root is None:
        pytest.skip("the reference repository's checkout is not present")
    record = eval_inversion_fidelity.main(
        ["--device", "cpu", "--reference_root", root, "--num", "1", "--n_iters", "1",
         "--resolution", "64", "--channel_base", "1024", "--channel_max", "16",
         "--num_layers", "3"])
    assert record["pass"] and record["recon_max_abs_diff"] < 1e-3
