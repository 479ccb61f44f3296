"""The port's `train_boundaries` CLI against the JAX package's `main`, both in
this process, on the CPU.

Both sample 100 latents from the same slim SG3-R 32² generator (a ``.npz``
written by the JAX package's `variables_to_npz` from its init with the zero
leaves seeded; 4 layers of at most 16 channels, which keeps the JAX bf16
renders on the CPU to seconds), render them in batches of 50 in the
generator's bf16 policy, score them with the same scorer and fit the
boundary on w0 with the SVM (2 % of 100: one positive and one negative
sample to train on). The JAX CLI inits its scorer from its own key; here
both CLIs' scorers get one seeded tree (`test_torch_encoders.init_module`).
The scorers resize to 32² instead of 224² in both packages (their
`resize_bilinear` patched): ResNet-50 on 100 images at 224² would take
minutes on the CPU; `test_torch_scorers.py` holds the scorers at 224².
`train_boundary` is wrapped in both CLIs to record what it is given.

Tolerances: the latents (fp32 mapping) within 1e-5 of max |ref|; the scores
(from bf16 renders, which the two packages round apart by up to
`RANGE_RENDER_TOL` = 2.2 % of the image) within 2.2 % of max |score|; the
saved boundary (a unit vector fitted on the same two rows of w0) within
1e-4.
"""

import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.editing import attribute_scorers as jscorers
from stylegan3_editing_tpu.models.sg3 import config as jcfg
from stylegan3_editing_tpu.models.sg3.convert import variables_to_npz
from stylegan3_editing_tpu_torch.editing import attribute_scorers as scorers
from stylegan3_editing_tpu_torch.editing.interfacegan import RANGE_RENDER_TOL
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from stylegan3_editing_tpu_torch.scripts import train_boundaries
from test_torch_encoders import generator_variables, init_module
from test_torch_styleclip_cli import jax_cli

torch.set_num_threads(1)

DECODER = dict(decoder_channel_base=2048, decoder_channel_max=16, decoder_num_layers=4)
WS_TOL = 1e-5
BOUNDARY_TOL = 1e-4
SCORER_SIZE = 32
CASES = {"Smiling": (jscorers.AttributeClassifier, scorers.AttributeClassifier, False),
         "pose_yaw": (jscorers.PoseEstimator, scorers.PoseEstimator, True)}


class _SeededInit:
    """A JAX scorer whose ``init`` gives the test's tree."""

    def __init__(self, module, variables):
        self.module, self.variables = module, variables

    def init(self, *args, **kwargs):
        return self.variables

    def apply(self, variables, images):
        return self.module.apply(variables, images)


def _recorder(fn, into):
    def call(codes, scores, **kwargs):
        into.update(codes=np.array(codes), scores=np.array(scores))
        return fn(codes, scores, **kwargs)
    return call


@pytest.fixture(scope="module")
def generator_npz(tmp_path_factory):
    root = tmp_path_factory.mktemp("boundaries")
    cfg = jcfg.sg3_r_config(32, **{k[len("decoder_"):]: v for k, v in DECODER.items()})
    variables_to_npz(generator_variables(cfg, seed=31), str(root / "G.npz"))
    return root / "G.npz"


@pytest.mark.parametrize("attribute", sorted(CASES))
def test_train_boundaries_matches_jax(attribute, generator_npz, tmp_path):
    jcls, tcls, pseudo_align = CASES[attribute]
    variables = init_module(jcls(), np.zeros((1, 224, 224, 3), np.float32), seed=32)
    port_scorer = tcls(device="cpu")
    load_jax_variables(port_scorer, variables)
    cli = jax_cli("train_boundaries")
    options = dict(generator_path=str(generator_npz), output_size=32, n_samples=100,
                   batch_size=50, attribute=attribute, pseudo_align=pseudo_align, seed=3,
                   **DECODER)
    seen = {"jax": {}, "port": {}}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jscorers, scorers):
            mp.setattr(mod, "resize_bilinear",
                       lambda x, size, _f=mod.resize_bilinear: _f(x, SCORER_SIZE))
        mp.setattr(cli, jcls.__name__, lambda: _SeededInit(jcls(), variables))
        mp.setattr(train_boundaries, tcls.__name__, lambda device, generator: port_scorer)
        mp.setattr(cli, "train_boundary", _recorder(cli.train_boundary, seen["jax"]))
        mp.setattr(train_boundaries, "train_boundary",
                   _recorder(train_boundaries.train_boundary, seen["port"]))
        cli.main(cli.BoundaryOptions(output_dir=str(tmp_path / "jax"), **options))
        train_boundaries.main([f"--{k}={v}" for k, v in options.items()]
                              + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    got, ref = seen["port"], seen["jax"]
    assert got["codes"].shape == ref["codes"].shape == (100, 512)
    assert got["scores"].shape == ref["scores"].shape == (100, 1)
    np.testing.assert_allclose(got["codes"], ref["codes"], rtol=0,
                               atol=WS_TOL * np.abs(ref["codes"]).max())
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0,
                               atol=RANGE_RENDER_TOL * np.abs(ref["scores"]).max())
    if pseudo_align:  # every w0 is w_avg: the two classes hold one point
        assert np.ptp(ref["codes"], axis=0).max() == 0
    else:
        order = [np.argsort(s[:, 0]) for s in (got["scores"], ref["scores"])]
        assert {*order[0][:2], *order[0][-2:]} == {*order[1][:2], *order[1][-2:]}
    name = f"{attribute}_boundary.npy"
    b_port, b_jax = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
    assert b_port.shape == b_jax.shape == (1, 512)
    np.testing.assert_allclose(b_port, b_jax, rtol=0, atol=BOUNDARY_TOL)


def test_train_boundaries_scores_on_the_card_path_without_sklearn(generator_npz, monkeypatch):
    """The steps up to the scores (`sample_ws`, `scorer_for`, `score_ws`)
    run with scikit-learn unavailable, as on the card's machine; only the
    fit needs it."""
    import sys

    monkeypatch.setitem(sys.modules, "sklearn", None)
    for mod in (scorers,):
        monkeypatch.setattr(mod, "resize_bilinear",
                            lambda x, size, _f=mod.resize_bilinear: _f(x, SCORER_SIZE))
    opts = train_boundaries.BoundaryOptions(generator_path=str(generator_npz), output_size=32,
                                            n_samples=10, batch_size=4, attribute="pose_yaw",
                                            device="cpu", **DECODER)
    G = train_boundaries.build_generator(opts, torch.device("cpu"))
    ws = train_boundaries.sample_ws(G, opts)
    scores = train_boundaries.score_ws(G, *train_boundaries.scorer_for(opts.attribute, "cpu"),
                                       ws, opts.batch_size)
    assert ws.shape == (10, G.num_ws, 512) and scores.shape == (10, 1)
    assert np.isfinite(scores).all()
    with pytest.raises(ImportError):
        train_boundaries.train_boundary(ws[:, 0].numpy(), scores)
