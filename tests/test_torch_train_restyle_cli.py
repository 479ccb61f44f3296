"""Both ReStyle training CLIs of the port, in-process on the CPU, and their
checkpoints read by both packages.

Each CLI trains on a folder of four PNGs the test writes (64², resized to
256² by the encode transforms), with the `decoder_*` overrides of
`scripts/train_e4e.sh`'s smoke run (32², channel base 512, max 32, 4
layers), the 8-layer IR-SE trunk patched into both packages' encoder types
(`test_torch_coach.slim_nets`), batch 1, one ReStyle iteration and the L2
loss (the e4e run adds the latent discriminator), for 2 steps; the e4e CLI
then resumes from its step-2 checkpoint for a third. The final checkpoint
goes through both packages' `load_encoder`, and the JAX encoder's codes of
one batch must be within 1e-4 of max |ref| of the port's (the encoders'
tolerance, `test_torch_encoders.py`).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.utils import inference_utils as jinference
from stylegan3_editing_tpu_torch.scripts import train_restyle_e4e, train_restyle_psp
from stylegan3_editing_tpu_torch.utils import inference_utils
from stylegan3_editing_tpu_torch.utils.cli import parse_dataclass
from test_torch_coach import slim_nets
from test_torch_encoders import check

torch.set_num_threads(1)

SLIM = ["--output_size", "32", "--decoder_channel_base", "512", "--decoder_channel_max", "32",
        "--decoder_num_layers", "4", "--batch_size", "1", "--test_batch_size", "1",
        "--effective_batch_size", "1", "--n_iters_per_batch", "1", "--l2_lambda", "1",
        "--board_interval", "1", "--image_interval", "2", "--val_interval", "2",
        "--max_val_batches", "1", "--max_steps", "2", "--device", "cpu"]


@functools.partial(jax.jit, static_argnums=0)
def jax_codes(jmodel, variables, x):
    """The JAX encoder's codes, residual to the decoder's ``w_avg`` (one
    compile per encoder type)."""
    return jmodel.apply(variables, x, latent_avg=variables["ema"]["decoder"]["mapping"]["w_avg"],
                        method=jmodel.encode)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both CLIs' runs: (exp_dir, coach) of pSp, e4e and the resumed e4e."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("cli")
    data = tmp / "faces"
    data.mkdir()
    rng = np.random.RandomState(50)
    for i in range(4):
        Image.fromarray(rng.randint(0, 256, (64, 64, 3), dtype=np.uint8)).save(data / f"{i}.png")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        slim_nets(mp)
        opts = parse_dataclass(train_restyle_psp.PspCliOptions, SLIM + [
            "--train_root", str(data), "--exp_dir", str(tmp / "psp")])
        runs["psp"] = train_restyle_psp.main(opts)
        e4e = SLIM + ["--train_root", str(data), "--save_interval", "2",
                      "--w_discriminator_lambda", "0.1",
                      "--w_pool_size", "2", "--d_reg_every", "2",
                      "--encoder_type", "ProgressiveBackboneEncoder"]
        runs["e4e"] = train_restyle_e4e.main(parse_dataclass(
            train_restyle_e4e.E4eCliOptions, e4e + ["--exp_dir", str(tmp / "e4e")]))
        runs["resumed"] = train_restyle_e4e.main(parse_dataclass(
            train_restyle_e4e.E4eCliOptions, e4e + [
                "--exp_dir", str(tmp / "resumed"), "--max_steps", "3",
                "--resume_training_from_ckpt",
                str(tmp / "e4e" / "checkpoints" / "iteration_2")]))
        x = np.tanh(rng.randn(1, 256, 256, 6)).astype(np.float32)
        codes = {}
        for name in runs:
            ckpt = tmp / name / "checkpoints" / "final_model"
            model, _ = inference_utils.load_encoder(ckpt, device="cpu")
            jmodel, jvars, jopts = jinference.load_encoder(str(ckpt))
            with torch.no_grad():
                got, own = (m.encode(torch.from_numpy(x),
                                     latent_avg=m.decoder.mapping.w_avg).numpy()
                            for m in (model, runs[name].model))
            ref = jax_codes(jmodel, jvars, jnp.asarray(x))
            codes[name] = (got, np.asarray(ref), jopts, own)
    # The checkpoints written, then their arrays dropped (~1 GB each at this size:
    # the encoder, its Ranger state and the decoder).
    written = {}
    for arrays in sorted(tmp.glob("*/checkpoints/*/arrays.npz")):
        written.setdefault(arrays.parents[2].name, []).append(arrays.parent.name)
        arrays.unlink()
    return tmp, runs, codes, written


@pytest.mark.parametrize("name", ["psp", "e4e", "resumed"])
def test_cli_checkpoints_load_in_both_packages(trained, name):
    """The final checkpoint's encoder gives the trained coach's codes in the
    port's `load_encoder` (to 0) and in the JAX package's, and its options
    come back (pSp or e4e)."""
    _, runs, codes, _ = trained
    got, ref, jopts, own = codes[name]
    np.testing.assert_array_equal(got, own)
    check(got, ref, 1e-4, f"{name} codes, port vs JAX load_encoder")
    assert jopts.encoder_type == runs[name].opts.encoder_type
    assert hasattr(jopts, "w_discriminator_lambda") == (name != "psp")


@pytest.mark.parametrize("name", ["psp", "e4e"])
def test_cli_writes_stats_events_grids_and_checkpoints(trained, name):
    tmp, runs, _, written = trained
    exp = tmp / name
    lines = [json.loads(line) for line in (exp / "stats.jsonl").read_text().splitlines()]
    assert [e["step"] for e in lines] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in lines)
    assert ("discriminator_loss" in lines[0]) == (name == "e4e")
    assert list((exp / "logs").glob("events.out.tfevents.*"))
    assert (exp / "logs" / "images_000002.png").exists()
    kept = ["best_model", "final_model"] + (["iteration_2"] if name == "e4e" else [])
    assert sorted(written[name]) == sorted(kept)
    for ckpt in kept:
        meta = json.loads((exp / "checkpoints" / f"{ckpt}.json").read_text())
        assert meta["global_step"] == 2 and meta["is_e4e"] == (name == "e4e")
    assert runs[name].global_step == 2 and runs[name].best_val_loss is not None


def test_e4e_cli_resumes_from_its_checkpoint(trained):
    """`--resume_training_from_ckpt` restores the step-2 state (the step, the
    discriminator and its Adam state) and trains a third step."""
    tmp, runs, _, written = trained
    assert written["resumed"] == ["final_model"]
    resumed, first = runs["resumed"], runs["e4e"]
    assert resumed.global_step == 3
    lines = [json.loads(line) for line in
             (tmp / "resumed" / "stats.jsonl").read_text().splitlines()]
    assert [e["step"] for e in lines] == [3]

    def adam_steps(coach):
        return int(coach.disc_optimizer.state[next(coach.disc.parameters())]["step"])

    assert adam_steps(first) == 3  # micro-steps 1 (with R1) and 2
    assert adam_steps(resumed) == 5  # and 3, with R1
