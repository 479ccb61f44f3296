"""`train_setgan --fid true` on the CPU: the in-loop conditional FID.

The PR-16 CLI test's slim configuration (64² SG3-T with 4 layers, the
8-layer IR-SE trunk, the tiny projected backbone, 64-wide latents) over a
folder of PNGs, two ticks with an evaluation at the second
(``--eval_ticks 1``; the first tick never evaluates), 2 classes of 2 items:
InceptionV3 at 299² with its seeded init, the ``agg`` FID of 2048-d
features. It prints ``{"tick": 1, "fid": …}`` with a finite FID, keeps it as
``best_fid`` and snapshots ``best_model``.
"""

import json
import math

from threadpoolctl import threadpool_limits

from stylegan3_editing_tpu_torch.runtime.checkpoint import load_pytree
from test_torch_setgan_train import Z_DIM
from test_torch_setgan_train_cli import class_folder  # noqa: F401 (a fixture)

ARGS = ["--resolution", "64", "--encoder_res", "64", "--cbase", "1024", "--cmax", "32",
        "--syn_layers", "4", "--batch", "2", "--reference_min", "2", "--reference_max", "3",
        "--candidate_min", "1", "--candidate_max", "2", "--backbones", "tiny_proj",
        "--encoder_num_layers", "8", "--d_latent", "32", "--g_attn_layers", "1",
        "--d_attn_layers", "1", "--total_kimg", "0.004", "--tick_kimg", "0.002",
        "--fid", "true", "--eval_ticks", "1", "--fid_classes", "2",
        "--fid_items_per_class", "2"]


def test_train_setgan_fid_true_on_the_cpu(class_folder, tmp_path, monkeypatch, capsys):  # noqa: F811
    from stylegan3_editing_tpu_torch.scripts import train_setgan

    sg3_t_config = train_setgan.sg3_t_config
    monkeypatch.setattr(train_setgan, "sg3_t_config",
                        lambda *a, **kw: sg3_t_config(*a, **kw, z_dim=Z_DIM, w_dim=Z_DIM))
    out = tmp_path / "run"
    with threadpool_limits(1):  # the sqrtm gains ~15 % from 8 BLAS threads, for 8x the CPU
        trainer = train_setgan.cli(["--data", str(class_folder), "--outdir", str(out),
                                    "--device", "cpu", *ARGS])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{") and '"fid"' in line]
    assert [e["tick"] for e in printed] == [1] and trainer.cur_tick == 2
    fid = printed[0]["fid"]
    assert math.isfinite(fid) and fid >= 0 and trainer.best_fid == fid
    _, meta = load_pytree(out / "best_model")
    assert meta["best_fid"] == fid and meta["cur_tick"] == 1
