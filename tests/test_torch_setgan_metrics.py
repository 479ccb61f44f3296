"""Parity of the port's SetGAN metrics and spectrum with the JAX package's, on the CPU.

`FeatureStats`, `frechet_distance` (scipy's ``sqrtm`` and the eigenvalue
route it falls back to) and the three `ConditionalFID` modes on the same
float64 features: equal to JAX's to float64 rounding (`MOMENT_RTOL` =
1e-12; the code is the same numpy). A `ConditionalMetrics` cache written by
either package reads in the other under the same file name.
`make_fid_eval_fn` is held against the JAX CLI's in
`test_torch_inception.py`, which shares its InceptionV3 compile.

The spectrum functions at odd and even sizes, with and without a centre,
on ``[N, H, W]`` and ``[N, H, W, C]`` inputs within `SPECTRUM_RTOL` = 1e-5
of max |ref| (fp32 FFTs in two libraries).
"""

import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.setgan import metrics as jm
from stylegan3_editing_tpu.utils import spectrum as jspec
from stylegan3_editing_tpu_torch.setgan import metrics as pm
from stylegan3_editing_tpu_torch.utils import spectrum as pspec

torch.set_num_threads(1)

MOMENT_RTOL = 1e-12
SPECTRUM_RTOL = 1e-5


def _feats(n, d, seed):
    return np.random.RandomState(seed).randn(n, d) * np.linspace(0.5, 2.0, d)


def test_feature_stats_match_jax():
    a, b = jm.FeatureStats(max_items=7), pm.FeatureStats(max_items=7)
    for seed, n in ((0, 3), (1, 3), (2, 5)):  # the third batch is cut at 7 items
        f = _feats(n, 6, seed)
        a.append(f)
        b.append(f)
    assert a.num == b.num == 7
    for x, y in zip(a.get_mean_cov(), b.get_mean_cov()):
        np.testing.assert_allclose(y, x, rtol=MOMENT_RTOL, atol=0)
    with pytest.raises(ValueError):
        pm.FeatureStats().get_mean_cov()


@pytest.mark.parametrize("case", ["full_rank", "rank_deficient", "fallback"])
def test_frechet_distance_matches_jax(case, monkeypatch):
    """Full rank (64 samples of 6 features), rank deficient (3 samples of
    8) and the eigenvalue route forced (``sqrtm`` raising in both)."""
    n, d = (64, 6) if case == "full_rank" else (3, 8)
    s1, s2 = pm.FeatureStats(), pm.FeatureStats()
    s1.append(_feats(n, d, 3))
    s2.append(_feats(n, d, 4) + 0.3)
    args = (*s1.get_mean_cov(), *s2.get_mean_cov())
    if case == "fallback":
        import scipy.linalg

        def refuse(*_, **__):
            raise np.linalg.LinAlgError("forced")

        monkeypatch.setattr(scipy.linalg, "sqrtm", refuse)
    want, got = jm.frechet_distance(*args), pm.frechet_distance(*args)
    assert np.isfinite(got) and got == pytest.approx(want, rel=MOMENT_RTOL, abs=0)


def _fill(fid, seed):
    rng = np.random.RandomState(seed)
    for cls in (3, 0, 5):
        fid.append_real(cls, rng.randn(6, 4))
        fid.append_fake(cls, rng.randn(5, 4) + 0.2 * cls)
    fid.append_real(9, rng.randn(4, 4))  # a class without fakes is left out
    return fid


@pytest.mark.parametrize("mode", ["agg", "sfid", "rfid"])
def test_conditional_fid_modes_match_jax(mode):
    want = _fill(jm.ConditionalFID(lambda x: x, max_items_per_class=5), 8).compute(mode)
    got = _fill(pm.ConditionalFID(lambda x: x, max_items_per_class=5), 8).compute(mode)
    assert got == pytest.approx(want, rel=MOMENT_RTOL, abs=0)
    with pytest.raises(ValueError):
        pm.ConditionalFID(lambda x: x).compute("nope")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_real_stats_cache_reads_across_packages(writer, tmp_path):
    """Each package's `ConditionalMetrics` names the cache alike; the
    moments one writes, the other reads (and skips the real images)."""
    rng = np.random.RandomState(11)
    split = {c: rng.randn(6, 4) for c in (0, 1)}

    def fake(cls, n):
        return np.random.RandomState(20 + cls).randn(n, 4) + 0.5

    def build(mod, feature_fn=lambda x: x):
        m = mod.ConditionalMetrics(feature_fn, cache_dir=tmp_path, detector_name="det")
        m.add_split("val", split, config={"res": 32, "name": "toy"})
        m.add_metric("fid", "agg")
        return m

    first, second = (jm, pm) if writer == "jax" else (pm, jm)
    value = build(first).calc_metric("fid", "val", fake, per_class=5)
    files = sorted(tmp_path.glob("*.npz"))
    config = {"res": 32, "name": "toy", "max_items_per_class": 5}
    assert files == [pm.stats_cache_file(tmp_path, "val", "det", config)] == \
        [jm.stats_cache_file(tmp_path, "val", "det", config)]
    seen = []

    def counting(x):
        seen.append(len(x))
        return x

    again = build(second, counting).calc_metric("fid", "val", fake, per_class=5)
    assert seen == [6, 6] and again == pytest.approx(value, rel=MOMENT_RTOL, abs=0)


@pytest.mark.parametrize("shape", [(2, 9, 9), (2, 8, 10), (2, 7, 8, 3), (3, 16, 16, 3)])
def test_spectrum_matches_jax(shape):
    x = np.random.RandomState(len(shape) + shape[1]).randn(*shape).astype(np.float32)
    nhw = x if x.ndim == 3 else x.mean(-1)
    got_p, want_p = pspec.power_spectrum(torch.from_numpy(x)), jspec.power_spectrum(x)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               atol=SPECTRUM_RTOL * float(np.abs(want_p).max()), rtol=0)
    for normalize in (False, True):
        f = pspec.batch_fft(torch.from_numpy(nhw), normalize)
        g = np.asarray(jspec.batch_fft(nhw, normalize))
        np.testing.assert_allclose(f.numpy(), g, atol=SPECTRUM_RTOL * np.abs(g).max(), rtol=0)
    for backwards in (False, True):
        np.testing.assert_array_equal(
            pspec.roll_quadrants(torch.from_numpy(nhw), backwards).numpy(),
            np.asarray(jspec.roll_quadrants(nhw, backwards)))
    power = np.abs(nhw) + 0.1
    for center in (None, (1.0, 2.5), (shape[1] - 1.0, 0.0)):
        got = pspec.azimuthal_average(torch.from_numpy(power), center).numpy()
        want = np.asarray(jspec.azimuthal_average(power, center))
        assert got.shape == want.shape, center
        np.testing.assert_allclose(got, want, atol=SPECTRUM_RTOL * np.abs(want).max(), rtol=0)
    got, want = pspec.spectrum_stats(torch.from_numpy(x)), jspec.spectrum_stats(x)
    for key in ("mean", "std"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, atol=SPECTRUM_RTOL * np.abs(w).max(),
                                   rtol=0, err_msg=key)


def test_sync_is_local_in_one_process():
    st = pm.FeatureStats()
    st.append(_feats(4, 3, 0))
    before = (st.num, st._sum.copy())
    assert st.sync_across_hosts() is st and st.sync_across_hosts() is st
    assert st.num == before[0] and np.array_equal(st._sum, before[1])
