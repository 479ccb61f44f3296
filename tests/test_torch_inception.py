"""Parity of the port's InceptionV3 (the FID network) with the JAX package's, on the CPU.

The 2048-d pool3 features of two 64² images, resized to 299² inside both
networks, from the same seeded variables (numpy, carried into the port by
`load_jax_variables`): kernels normal with std 1/sqrt(fan in), batch-norm
statistics non-trivial. One JAX compile of the network's apply (the
variables an argument), shared by the tests.

Tolerance: the features within `FEATURE_TOL` = 1e-5 of their max |ref|
(fp32 sum order over 94 convs; the JAX convs run in XLA, the port's in
PyTorch's convolution), each pool patch's block within `STAGE_TOL` = 1e-5 of
its max |ref|; the converters' trees equal leaf for leaf.

The FID patches are held at the border, where they act: an InceptionA and
both InceptionE variants on a 5×5 input against the JAX blocks, and
against blocks with the patch undone (``count_include_pad=True``, an
average pool in Mixed_7c), which must differ.

`scripts.train_setgan.make_fid_eval_fn` against the JAX CLI's with a stub
trainer that renders the same arrays in both, and the fixture's variables
read from ``--inception_path``: the classes drawn, the reference halves,
and the per-class feature moments that the FID is computed from
(`ConditionalFID.compute` is stood in for by one that returns them: a
2048-d ``sqrtm`` takes some 20 s on the CPU, and `frechet_distance` is held
in `test_torch_setgan_metrics.py`). Sums within `FEATURE_TOL` of max |ref|
and outer products within 2·`FEATURE_TOL` (the features are ReLU
outputs, so a sum's error stays within its scale's).
"""

import importlib.util
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stylegan3_editing_tpu.models.backbones import inception as jinc
from stylegan3_editing_tpu.setgan import metrics as jm
from stylegan3_editing_tpu_torch.models.backbones import inception as pinc
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables, to_jax_variables
from stylegan3_editing_tpu_torch.setgan import metrics as pm

torch.set_num_threads(1)

FEATURE_TOL = 1e-5
STAGE_TOL = 1e-5


def seed_tree(shapes, seed):
    """A numpy tree shaped as ``shapes`` (a `jax.eval_shape` tree)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [p.key for p in path]
        z = rng.standard_normal(leaf.shape, dtype=np.float32)
        if names[0] == "batch_stats":
            v = 0.1 * z if names[-1] == "mean" else 0.5 + np.abs(z)
        elif names[-1] == "kernel":
            v = z / math.sqrt(math.prod(leaf.shape[:-1]))
        elif names[-1] == "scale":
            v = 1 + 0.1 * z
        else:
            v = 0.1 * z
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


_APPLY = jax.jit(jinc.InceptionV3Features().apply)


def _jax_feature_fn(variables):
    """`inception.inception_feature_fn` of the JAX package, on one jitted
    apply that takes the variables as an argument: one compile a shape."""
    return lambda images: _APPLY(variables, jnp.asarray(images, jnp.float32))


@pytest.fixture(scope="module")
def features():
    x = np.tanh(np.random.RandomState(0).randn(2, 64, 64, 3)).astype(np.float32)
    model = jinc.InceptionV3Features()
    variables = seed_tree(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    return x, variables, np.asarray(_jax_feature_fn(variables)(x))


def test_features_match_jax(features):
    x, variables, want = features
    got = pinc.inception_feature_fn(variables, device="cpu")(x)
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    print(f"inception features: max abs err {err:.3g}, max |ref| {scale:.3g}")
    assert scale > 0 and err <= FEATURE_TOL * scale
    # A tensor input gives the same features.
    np.testing.assert_array_equal(
        pinc.inception_feature_fn(variables, device="cpu")(torch.from_numpy(x)), got)


def test_tree_matches_jax(features):
    _, variables, _ = features
    port = pinc.InceptionV3Features(generator=torch.Generator().manual_seed(0))
    mine = to_jax_variables(port)
    flat = {c: dict(jax.tree_util.tree_flatten_with_path(t)[0]) for c, t in mine.items()}
    theirs = {c: dict(jax.tree_util.tree_flatten_with_path(t)[0]) for c, t in variables.items()}
    assert flat.keys() == theirs.keys()
    for c in flat:
        assert {jax.tree_util.keystr(k): v.shape for k, v in flat[c].items()} == \
            {jax.tree_util.keystr(k): v.shape for k, v in theirs[c].items()}, c


def _oihw(v):
    return np.asarray(v).transpose(3, 2, 0, 1)


def test_convert_inception_matches_jax():
    """A seeded state dict in torchvision / pytorch-fid naming
    (``Mixed_6b.branch7x7_2.conv.weight``, ``….bn.running_var``) → the same
    tree in both packages, loadable into the port."""
    port = pinc.InceptionV3Features(generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    state = {}
    bn = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    for key, value in port.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        v = rng.standard_normal(tuple(value.shape)).astype(np.float32)
        if leaf == "kernel":
            state[f"{owner}.weight"] = _oihw(v)
        else:
            state[f"{owner}.{bn[leaf]}"] = v
    got, want = pinc.convert_inception(state), jinc.convert_inception(state)
    flat_got = {c: dict(jax.tree_util.tree_flatten_with_path(t)[0]) for c, t in got.items()}
    flat_want = {c: dict(jax.tree_util.tree_flatten_with_path(t)[0]) for c, t in want.items()}
    assert flat_got.keys() == flat_want.keys()
    for c in flat_got:
        assert flat_got[c].keys() == flat_want[c].keys()
        for k, v in flat_want[c].items():
            np.testing.assert_array_equal(flat_got[c][k], np.asarray(v), err_msg=str(k))
    load_jax_variables(port, got)
    assert len(pinc._BLOCKS) == 94


def test_rectangular_kernels_and_padding_match_flax():
    """`Conv2d` with a (1, 7) / (7, 1) / (1, 3) / (3, 1) kernel and per-axis
    padding computes what flax's ``nn.Conv`` with that padding computes."""
    from flax import linen as fnn

    from stylegan3_editing_tpu_torch.models.backbones.common import Conv2d

    x = np.random.RandomState(4).randn(2, 9, 11, 5).astype(np.float32)
    for kernel, pad in (((1, 7), (0, 3)), ((7, 1), (3, 0)), ((1, 3), (0, 1)), ((3, 1), (1, 0))):
        conv = Conv2d(5, 6, kernel, 1, pad, generator=torch.Generator().manual_seed(5),
                      use_bias=False)
        want = fnn.Conv(6, kernel, padding=((pad[0], pad[0]), (pad[1], pad[1])),
                        use_bias=False).apply({"params": {"kernel": conv.kernel.detach().numpy()}},
                                              x)
        with torch.no_grad():
            got = conv(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 9, 11, 6), kernel
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def _block_case(jblock, pblock, seed):
    x = np.random.RandomState(seed).randn(1, 5, 5, 8).astype(np.float32)
    variables = seed_tree(jax.eval_shape(jblock.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                          seed)
    want = np.asarray(jblock.apply(variables, x))
    load_jax_variables(pblock, variables)
    return x, want


def _close(block, x, want):
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    return float(np.abs(got - want).max()) <= STAGE_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("kind", ["A", "E_avg", "E_max"])
def test_pool_patches_match_jax_at_the_border(kind, monkeypatch):
    g = torch.Generator().manual_seed(6)
    jblock, pblock = {"A": (jinc.InceptionA(4), pinc.InceptionA(8, 4, g)),
                      "E_avg": (jinc.InceptionE("avg"), pinc.InceptionE(8, "avg", g)),
                      "E_max": (jinc.InceptionE("max"), pinc.InceptionE(8, "max", g))}[kind]
    x, want = _block_case(jblock, pblock.eval(), 7)
    assert _close(pblock, x, want)
    # Undo the patch: counting the padding (the avg branches), or an average
    # pool in Mixed_7c; the border changes the block's output.
    if kind == "E_max":
        pblock.pool = "avg"
    else:
        monkeypatch.setattr(pinc, "_avg_pool_3x3_same", lambda t: F.avg_pool2d(
            t.permute(0, 3, 1, 2), 3, 1, 1, count_include_pad=True).permute(0, 2, 3, 1))
    assert not _close(pblock, x, want)


def test_inception_feature_fn_keeps_its_seeded_init():
    a = pinc.inception_feature_fn(device="cpu")
    b = pinc.inception_feature_fn(device="cpu")
    x = np.zeros((1, 32, 32, 3), np.float32)
    out = a(x)
    assert out.shape == (1, 2048) and np.isfinite(out).all()
    np.testing.assert_array_equal(out, b(x))


# ------------------------------------------------------ the CLI's evaluation

def _jax_cli():
    spec = importlib.util.spec_from_file_location("train_setgan_jax_cli",
                                                  str(Path(__file__).resolve().parents[1] / "scripts" / "train_setgan.py"))
    cli = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = cli  # dataclass introspection needs the module
    spec.loader.exec_module(cli)
    return cli


class _Classes:
    """The duck-typed dataset `make_fid_eval_fn` reads."""

    def __init__(self, n_classes, per, side, seed):
        rng = np.random.RandomState(seed)
        self.images = np.tanh(rng.randn(n_classes * per, side, side, 3)).astype(np.float32)
        self.classes = [f"c{i}" for i in range(n_classes)]
        self.class_to_paths = {c: list(range(i * per, (i + 1) * per))
                               for i, c in enumerate(self.classes)}

    def load(self, path):
        return self.images[path]


class _StubTrainer:
    """`generate` as a fixed function of the references: the same arrays
    in both packages."""

    def __init__(self):
        self.calls = []

    def generate(self, refs, num_candidates, use_ema=True):
        refs = np.asarray(refs)
        self.calls.append((refs.shape, float(refs.sum()), num_candidates, use_ema))
        mean = refs.mean(axis=1, keepdims=True)
        ramp = np.linspace(-0.3, 0.3, num_candidates, dtype=np.float32)[None, :, None, None, None]
        return np.tanh(mean[:, [0] * num_candidates] * 0.8 + ramp).astype(np.float32)


def _moments(self, mode):
    """`ConditionalFID.compute` stood in for: the classes' moments."""
    return {side: {c: (st.num, st._sum, st._outer) for c, st in store.items()}
            for side, store in (("real", self.real), ("fake", self.fake))}


def test_make_fid_eval_fn_matches_jax(features, tmp_path, monkeypatch):
    """The JAX CLI's evaluation against the port's, on the fixture's
    variables read from ``--inception_path`` (2 items a class at 64²: the
    fixture's compile serves it)."""
    from stylegan3_editing_tpu_torch.runtime.checkpoint import save_pytree
    from stylegan3_editing_tpu_torch.scripts import train_setgan as pcli

    save_pytree(tmp_path / "inception", features[1])
    data = _Classes(3, 2, 64, 13)
    kw = dict(fid_classes=2, fid_items_per_class=2, seed=3, fid_mode="sfid",
              inception_path=str(tmp_path / "inception"))
    jcli = _jax_cli()
    monkeypatch.setattr(jinc, "inception_feature_fn", _jax_feature_fn)
    monkeypatch.setattr(jm.ConditionalFID, "compute", _moments)
    monkeypatch.setattr(pm.ConditionalFID, "compute", _moments)
    want_tr, got_tr = _StubTrainer(), _StubTrainer()
    jfn = jcli.make_fid_eval_fn(jcli.SetGANCliOptions(**kw), data)
    pfn = pcli.make_fid_eval_fn(pcli.SetGANCliOptions(device="cpu", **kw), data)
    for _ in range(2):  # the second call draws on from the same stream
        want, got = jfn(want_tr), pfn(got_tr)
        for side in ("real", "fake"):
            assert sorted(got[side]) == sorted(want[side]) and len(got[side]) == 2
            for c, (n, s, o) in want[side].items():
                gn, gs, go = got[side][c]
                assert gn == n == 2 and gs.dtype == go.dtype == np.float64
                np.testing.assert_allclose(gs, s, rtol=0, atol=FEATURE_TOL * np.abs(s).max())
                np.testing.assert_allclose(go, o, rtol=0, atol=2 * FEATURE_TOL * np.abs(o).max())
    assert got_tr.calls == want_tr.calls and len(got_tr.calls) == 4
    assert all(c[0] == (1, 1, 64, 64, 3) and c[2] == 2 and c[3] for c in got_tr.calls)
