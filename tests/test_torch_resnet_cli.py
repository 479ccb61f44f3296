"""A reference ResNet-34 ReStyle checkpoint through the port's converter,
`load_encoder` and the inversion CLI, on the CPU.

The checkpoint is written in the test in the reference's format
(`resnet_reference_state` of `test_torch_resnet_encoders.py` under
``encoder.*``, a seeded slim SG3-R 64² decoder from the JAX package's init
under ``decoder.*``, and the options); the parity of the ResNet modules and
of the converter with the JAX package is held in
`test_torch_resnet_encoders.py`.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu_torch.data import BatchIterator, ImagesDataset, encode_transforms
from stylegan3_editing_tpu_torch.models.encoders import get_average_image, run_restyle_iterations
from stylegan3_editing_tpu_torch.scripts import convert_checkpoint
from stylegan3_editing_tpu_torch.utils.inference_utils import load_encoder
from test_torch_checkpoints import reference_state
from test_torch_encoders import check, generator_variables
from test_torch_resnet_encoders import resnet_reference_state

torch.set_num_threads(1)


def test_resnet_checkpoint_runs_through_the_inversion_cli(tmp_path):
    """A reference ResNet e4e checkpoint (``encoder.*``, ``decoder.*``,
    ``opts``) converted by `convert_checkpoint` goes through `load_encoder`
    and the ``inference_iterative`` CLI (``python -m``, ``--device cpu``)
    with no ResNet-specific step: the CLI's latents equal the module API's
    on the same images within 1e-5 of max |ref| (one process against
    another, the same code)."""
    from PIL import Image

    decoder = dict(channel_base=1024, channel_max=64, num_layers=4)  # SG3-R, as load_encoder
    n_styles = jcfg.sg3_r_config(64, **decoder).num_ws
    gv = jax.tree_util.tree_map(np.asarray, generator_variables(
        jcfg.sg3_r_config(64, **decoder), seed=82))
    state = {f"encoder.{k}": torch.from_numpy(v)
             for k, v in resnet_reference_state(n_styles, seed=83).items()}
    state.update({f"decoder.{k}": v for k, v in reference_state(gv, np.eye(3)).items()})
    torch.save({"state_dict": state, "opts": {"encoder_type": "ResNetProgressiveBackboneEncoder",
                                              "output_size": 64}},
               tmp_path / "restyle_resnet.pt")
    meta = convert_checkpoint.convert(str(tmp_path / "restyle_resnet.pt"), str(tmp_path / "enc"),
                                      kind="encoder", cfg_overrides=decoder)
    faces = tmp_path / "faces"
    faces.mkdir()
    rng = np.random.RandomState(84)
    for name in ("a.png", "b.png"):
        Image.fromarray(rng.randint(0, 256, (40, 48, 3), dtype=np.uint8)).save(faces / name)
    out = subprocess.run(
        [sys.executable, "-m", "stylegan3_editing_tpu_torch.scripts.inference_iterative",
         "--device", "cpu", "--checkpoint_path", meta["checkpoint"], "--data_path", faces,
         "--exp_dir", tmp_path / "out", "--n_iters_per_batch", "2"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    latents = np.load(tmp_path / "out" / "latents.npy", allow_pickle=True).item()

    model, opts = load_encoder(meta["checkpoint"], device="cpu")
    assert opts.encoder_type == "ResNetProgressiveBackboneEncoder" and model.is_progressive
    t_in = encode_transforms()["transform_inference"]
    (x, _), = list(BatchIterator(ImagesDataset(faces, faces, target_transform=t_in), 2,
                                 shuffle=False).epoch_batches())
    with torch.no_grad():
        avg, lat = get_average_image(model)
        results = run_restyle_iterations(model, torch.from_numpy(x), avg, lat, n_iters=2)
    for bi, name in enumerate(("a.png", "b.png")):
        ref = np.stack([codes[bi].numpy() for _, _, codes in results])
        assert latents[name].shape == (2, n_styles, 512)
        check(latents[name], ref, 1e-5, f"CLI latents of {name}")
