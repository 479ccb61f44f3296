"""Parity of the ReStyle trainer's parts in the port with the JAX package's,
on the CPU: the w-norm and MoCo criteria (with the MoCo converter), the
latent discriminator and its pool, the training statistics, the event
writer, the image grids, the training helpers, the device prefetcher and the
profiling scopes.

Weights are the port's seeded ones, carried into the JAX modules with
`to_jax_variables` (ResNet-50's batch norms given non-trivial statistics).

Tolerances: `w_norm_loss` 1e-6 relative (one sum and a sqrt per image); the
discriminator's logits 1e-5 of max |ref| (4 fp32 matmuls); MoCo's three
logs (cosines) 1e-4 of max |ref| (ResNet-50's 53 convs at 224², summed in
another order; the encoders' tolerance); everything else (the converter,
the pools, the statistics, the event records but for their wall time, the
grids, the aggregates, the prefetcher's order) equal. MoCo's loss and
similarity improvement were stated at 1e-4 of max |ref| too; the loss is
1 − a cosine of 0.9997 (a random trunk's pooled ReLU features are nearly
parallel) and differed by one ulp of 1 (1.2e-7), so both take the coach's
metric tolerance, 1e-4 relative plus 2⁻²⁰ (`test_torch_coach.py`).
"""

import struct
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.criteria import moco_loss as jmoco
from stylegan3_editing_tpu.criteria import w_norm as jw_norm
from stylegan3_editing_tpu.data import prefetch as jprefetch
from stylegan3_editing_tpu.models.backbones import resnet as jresnet
from stylegan3_editing_tpu.runtime import events as jevents
from stylegan3_editing_tpu.runtime import training_stats as jstats
from stylegan3_editing_tpu.training import latent_discriminator as jdisc
from stylegan3_editing_tpu.utils import train_utils as jtrain_utils
from stylegan3_editing_tpu_torch.criteria import MocoLoss, w_norm_loss
from stylegan3_editing_tpu_torch.data.prefetch import DevicePrefetcher, maybe_prefetch, to_device
from stylegan3_editing_tpu_torch.models.backbones import (ResNet50Features,
                                                          convert_resnet50_state)
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables, to_jax_variables
from stylegan3_editing_tpu_torch.runtime import events, profiling, training_stats
from stylegan3_editing_tpu_torch.training import LatentCodesDiscriminator, LatentCodesPool
from stylegan3_editing_tpu_torch.utils import train_utils
from test_torch_encoders import check, seeded, t

torch.set_num_threads(1)


# ----------------------------------------------------------------- criteria

@pytest.mark.parametrize("from_avg", [True, False])
def test_w_norm_loss_matches_jax(from_avg):
    latent, avg = seeded(3, 6, 512, seed=1), seeded(512, seed=2)
    ref = float(jw_norm.w_norm_loss(jnp.asarray(latent), jnp.asarray(avg), from_avg))
    got = float(w_norm_loss(t(latent), t(avg), from_avg))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def _resnet50_reference_state(seed):
    """A torchvision-format resnet50 state dict (no fc), seeded."""
    rng = np.random.RandomState(seed)
    state = {}

    def conv(name, cin, cout, k):
        state[f"{name}.weight"] = (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)).astype(
            np.float32)

    def bn(name, c):
        state[f"{name}.weight"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
        state[f"{name}.bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        state[f"{name}.running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        state[f"{name}.running_var"] = (0.5 + np.abs(rng.randn(c))).astype(np.float32)

    conv("conv1", 3, 64, 7)
    bn("bn1", 64)
    cin = 64
    for s, (blocks, width, cout, _) in enumerate(jresnet._STAGES, start=1):
        for b in range(blocks):
            p = f"layer{s}.{b}"
            conv(f"{p}.conv1", cin, width, 1), bn(f"{p}.bn1", width)
            conv(f"{p}.conv2", width, width, 3), bn(f"{p}.bn2", width)
            conv(f"{p}.conv3", width, cout, 1), bn(f"{p}.bn3", cout)
            if b == 0:
                conv(f"{p}.downsample.0", cin, cout, 1), bn(f"{p}.downsample.1", cout)
            cin = cout
    return state


@pytest.fixture(scope="module")
def moco():
    """A MoCo loss from a MoCo-format state (``module.encoder_q.`` prefixed,
    the fc head left out), through both converters."""
    state = _resnet50_reference_state(3)
    moco_state = {f"module.encoder_q.{k}": v for k, v in state.items()}
    stripped = {k[len("module.encoder_q."):]: v for k, v in moco_state.items()}
    return stripped, convert_resnet50_state(stripped), jresnet.convert_resnet50_state(stripped)


def test_moco_converter_matches_jax(moco):
    _, got, ref = moco
    flat_got, flat_ref = {}, {}
    for tree, out in ((got, flat_got), (ref, flat_ref)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[tuple(p.key for p in path)] = np.asarray(leaf)
    assert flat_got.keys() == flat_ref.keys()
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg=str(k))
    load_jax_variables(ResNet50Features(), got)  # every leaf has its tensor


def test_moco_loss_matches_jax_and_detaches_the_target(moco):
    """The nearest resize of 64² images to 224², ResNet-50, unit features;
    the loss, the similarity improvement and the three logs; no gradient
    reaches y."""
    _, variables, _ = moco
    loss_fn = MocoLoss(device="cpu")
    load_jax_variables(loss_fn.model, variables)
    y_hat, y, x = (np.tanh(seeded(2, 64, 64, 3, seed=s)) for s in (4, 5, 6))
    ref = jax.jit(jmoco.MocoLoss().apply)({c: {"model": v} for c, v in variables.items()},
                                          y_hat, y, x)
    ty_hat, ty = t(y_hat).requires_grad_(), t(y).requires_grad_()
    loss, sim, logs = loss_fn(ty_hat, ty, t(x))
    for got, want in ((loss, ref[0]), (sim, ref[1])):
        assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want)) + 2.0 ** -20
    for k in ("diff_target", "diff_input", "diff_views"):
        check(logs[k].detach(), ref[2][k], 1e-4, f"MocoLoss {k}")
    loss.backward()
    assert ty.grad is None and float(ty_hat.grad.abs().max()) > 0


# ------------------------------------------------------------ discriminator

def test_discriminator_matches_jax():
    disc = LatentCodesDiscriminator(64, 4, generator=torch.Generator().manual_seed(7))
    v = to_jax_variables(disc)
    assert set(v["params"]) == {"fc0", "fc1", "fc2", "out"}
    w = seeded(5, 64, seed=8)
    ref = jdisc.LatentCodesDiscriminator(64, 4).apply(v, jnp.asarray(w))
    with torch.no_grad():
        check(disc(t(w)), ref, 1e-5, "LatentCodesDiscriminator")


def test_pools_answer_the_jax_pools_queries():
    """The same queries (2-D and 3-D, past the pool's size) give the same
    answers and leave the same codes, for every seed the coach uses."""
    rng = np.random.RandomState(9)
    queries = [rng.randn(2, 8).astype(np.float32), rng.randn(3, 5, 8).astype(np.float32),
               rng.randn(4, 8).astype(np.float32), rng.randn(2, 1, 8).astype(np.float32)]
    for size in (0, 3):
        got, ref = LatentCodesPool(size), jdisc.LatentCodesPool(size)
        for q in queries:
            np.testing.assert_array_equal(got.query(q), ref.query(q))
        assert len(got.ws) == len(ref.ws) == size
        for a, b in zip(got.ws, ref.ws):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- runtime

def test_stats_collector_matches_jax():
    rng = np.random.RandomState(10)
    reports = [("loss", rng.randn()), ("loss", rng.randn(4)), ("acc", rng.randn(2, 3)),
               ("loss", np.asarray(jstats.moments(jnp.asarray(rng.randn(5)))))]
    got, ref = training_stats.StatsCollector(), jstats.StatsCollector()
    for name, value in reports:
        got.report(name, torch.as_tensor(value) if np.ndim(value) else value)
        ref.report(name, value)
    assert got.as_dict() == ref.as_dict()
    x = rng.randn(7).astype(np.float32)
    np.testing.assert_allclose(training_stats.moments(t(x)).numpy(),
                               np.asarray(jstats.moments(jnp.asarray(x))), rtol=1e-6)
    got.reset()
    assert got.names() == [] and np.isnan(got.mean("loss"))


def _records(path):
    """The TFRecord bodies of an event file, each crc checked."""
    data, out, pos = path.read_bytes(), [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == events._masked_crc(header)
        body = data[pos + 12:pos + 12 + length]
        assert struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])[0] == \
            events._masked_crc(body)
        out.append(body)
        pos += 16 + length
    return out


def test_event_writer_records_match_jax(tmp_path):
    """The same scalars and image written by both writers: every record equal
    but for its wall time (field 1, a double after the tag byte 0x09)."""
    img = np.tanh(seeded(8, 12, 3, seed=11))
    files = []
    for name, module in (("port", events), ("jax", jevents)):
        writer = module.EventWriter(tmp_path / name)
        writer.scalars({"loss": 0.25, "nan": float("nan"), "step_count": 3}, step=7)
        writer.scalar("lr", 1e-4, step=8)
        writer.image("grid", img, step=9)
        writer.close()
        files.append(writer.path)
    got, ref = (_records(p) for p in files)
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert a[0] == b[0] == 0x09 and a[9:] == b[9:]
    assert b"brain.Event:2" in got[0] and b"grid" in got[-1]
    for data in (b"", b"abc", bytes(range(256))):
        assert events.crc32c(data) == jevents.crc32c(data)
        assert events._masked_crc(data) == jevents._masked_crc(data)


def test_grids_and_helpers_match_jax(tmp_path):
    """`to_uint8`, `make_grid` (with and without cols), `save_image_grid`,
    `aggregate_loss_dict` and `vis_faces` as the JAX package's."""
    imgs = np.tanh(seeded(5, 6, 7, 3, seed=12))
    np.testing.assert_array_equal(events.to_uint8(imgs), jevents.to_uint8(imgs))
    for cols in (None, 2, 5):
        np.testing.assert_array_equal(events.make_grid(imgs, cols), jevents.make_grid(imgs, cols))
    grid = events.save_image_grid(imgs, tmp_path / "g.png", cols=4)
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g.png")), grid)
    dicts = [{"loss": 1.0, "id": 0.5}, {"loss": 3.0}, {"id": np.float32(1.5)}]
    assert train_utils.aggregate_loss_dict(dicts) == jtrain_utils.aggregate_loss_dict(dicts)
    faces = [{"input_face": imgs[0], "target_face": imgs[1],
              "output_face": [(imgs[2], "a"), (imgs[3], "b")], "diff_target": 0.75},
             {"input_face": imgs[4], "target_face": imgs[0], "output_face": imgs[1]}]
    np.testing.assert_array_equal(np.asarray(train_utils.vis_faces(faces, cell=16)),
                                  np.asarray(jtrain_utils.vis_faces(faces, cell=16)))
    port_faces = [{**f, "input_face": torch.from_numpy(f["input_face"])} for f in faces]
    np.testing.assert_array_equal(np.asarray(train_utils.vis_faces(port_faces, cell=16)),
                                  np.asarray(jtrain_utils.vis_faces(faces, cell=16)))


def test_module_summary_counts_parameters():
    disc = LatentCodesDiscriminator(8, 3)
    text = events.module_summary(disc)
    assert "fc0" in text and "out" in text
    assert text.splitlines()[-1].split()[-1] == f"{sum(p.numel() for p in disc.parameters()):,d}"


# ------------------------------------------------------------- prefetcher

def test_prefetcher_keeps_order_and_places_ahead():
    placed = []

    def place(b):
        placed.append(b)
        return b * 10

    for module in (jprefetch, None):
        placed.clear()
        cls = module.DevicePrefetcher if module else DevicePrefetcher
        out = list(cls(iter(range(6)), place, depth=2))
        assert out == [0, 10, 20, 30, 40, 50] and placed == list(range(6))
    assert list(maybe_prefetch(iter(range(3)), place, 0)) == [0, 10, 20]
    assert list(maybe_prefetch(iter(range(3)), place, 1)) == [0, 10, 20]


def test_prefetcher_reraises_errors_and_closes():
    def place(b):
        if b == 2:
            raise ValueError("bad batch")
        return b

    pf = DevicePrefetcher(iter(range(5)), place, depth=1)
    assert next(pf) == 0 and next(pf) == 1
    with pytest.raises(ValueError, match="bad batch"):
        next(pf)

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = DevicePrefetcher(endless(), lambda b: b, depth=2)
    assert next(pf) == 0
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    with DevicePrefetcher(iter([]), lambda b: b) as pf:
        with pytest.raises(StopIteration):
            next(pf)


def test_to_device_places_float32_batches_on_the_cpu():
    x = np.ones((1, 4, 4, 3), np.float64)
    placed = to_device(torch.device("cpu"))((x, x.astype(np.float32)))
    assert len(placed) == 2 and all(p.dtype == torch.float32 for p in placed)
    np.testing.assert_array_equal(placed[0].numpy(), x)


# -------------------------------------------------------------- profiling

def test_profiled_scopes_and_trace(tmp_path):
    profiling.drain_scope_times()

    @profiling.profiled_function
    def work():
        time.sleep(0.01)

    with profiling.profiled_scope("outer"):
        work()
    times = profiling.drain_scope_times()
    assert set(times) == {"outer", work.__qualname__} and times["outer"] >= 0.01
    assert profiling.drain_scope_times() == {}
    assert profiling.stop_trace() is None
    assert profiling.maybe_start_trace(str(tmp_path)) is True
    assert profiling.maybe_start_trace(str(tmp_path)) is False  # one at a time
    with profiling.profiled_scope("traced"):
        torch.ones(3).sum()
    assert profiling.stop_trace() == str(tmp_path)
    trace = next(tmp_path.glob("trace_*.json")).read_text()
    assert "traced" in trace


def test_trace_starts_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("SG3TPU_TRACE_DIR", raising=False)
    assert profiling.maybe_start_trace() is False
    monkeypatch.setenv("SG3TPU_TRACE_DIR", str(tmp_path / "env"))
    assert profiling.maybe_start_trace() is True
    assert profiling.stop_trace() == str(tmp_path / "env")
    assert list((tmp_path / "env").glob("trace_*.json"))
