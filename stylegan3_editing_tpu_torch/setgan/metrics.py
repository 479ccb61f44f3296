"""Class-conditional FID for SetGAN's evaluation.

Counterpart of the JAX package's `setgan/metrics.py` (the reference's `FID`
with its sfid, rfid and aggregate modes, and `FeatureStats` with the
per-class splits). The feature extractor is any ``features(x_nhwc) → [N,
D]`` callable; `models.backbones.inception.inception_feature_fn` is the
default. Moments accumulate in float64 on the host, as in the JAX package,
and `frechet_distance` takes scipy's ``sqrtm``.

The real-side moments cache to an ``.npz`` whose name is the md5 of the
split's sorted config, the same name and layout as the JAX package's, so a
cache written by either package loads in the other.

One process only: `FeatureStats.sync_across_hosts` and
`ConditionalFID._sync_stores` do nothing without ``torch.distributed`` (or
in a group of one), and raise under a process group of more ranks, where
the cross-rank sum of the moments is needed (ROADMAP Queue 1 #10, slice 19).
"""

from __future__ import annotations

import hashlib
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _refuse_many_ranks(what: str) -> None:
    if _world_size() > 1:
        raise NotImplementedError(
            f"{what} across {_world_size()} ranks needs the cross-rank sum of the feature "
            "moments, which is not ported yet (ROADMAP Queue 1 #10, slice 19)")


class FeatureStats:
    """Streaming mean and covariance of feature batches (float64 moments)."""

    def __init__(self, dim: Optional[int] = None, max_items: Optional[int] = None):
        self.dim = dim
        self.max_items = max_items
        self.num = 0
        self._sum = None
        self._outer = None
        self._synced = False

    def _init_zero(self, dim: int) -> None:
        """Zero moments (for a class another rank saw first)."""
        self.dim = dim
        self._sum = np.zeros(dim)
        self._outer = np.zeros((dim, dim))

    def append(self, feats) -> None:
        feats = np.asarray(feats, np.float64)
        if self.max_items is not None and self.num >= self.max_items:
            return
        if self.max_items is not None:
            feats = feats[:self.max_items - self.num]
        if self._sum is None:
            self._init_zero(feats.shape[1])
        self._sum += feats.sum(axis=0)
        self._outer += feats.T @ feats
        self.num += feats.shape[0]

    def get_mean_cov(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.num <= 1:
            raise ValueError(f"need at least 2 samples, have {self.num}")
        mu = self._sum / self.num
        cov = self._outer / self.num - np.outer(mu, mu)
        return mu, cov

    def sync_across_hosts(self) -> "FeatureStats":
        """The moments summed over every rank: a no-op in one process
        (idempotent, like the JAX package's); raises under a process group of
        more than one rank."""
        if self._sum is None or self._synced:
            return self
        _refuse_many_ranks("FeatureStats.sync_across_hosts")
        return self


def stats_cache_file(cache_dir, dataset_name: str, detector_name: str,
                     config: Optional[dict] = None) -> Path:
    """The cache path of a dataset's real-side moments:
    ``{dataset}-{detector}-{md5 of repr(sorted(config.items()))}.npz``, so a
    change of the dataset's options, the detector or the statistics'
    options makes a new entry."""
    md5 = hashlib.md5(repr(sorted((config or {}).items())).encode("utf-8")).hexdigest()
    return Path(cache_dir) / f"{dataset_name}-{detector_name}-{md5}.npz"


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """The Fréchet distance of two Gaussians, with scipy's ``sqrtm``. Where
    ``sqrtm`` fails or is not finite (rank-deficient covariances from few
    samples), tr √(cov1·cov2) is the sum of the square roots of the
    eigenvalues' real parts, clipped at 0. (The JAX package passes
    ``disp=False``, which scipy 1.18 removed; the root is the same.)"""
    import scipy.linalg

    diff = mu1 - mu2
    try:
        with warnings.catch_warnings():  # scipy < 1.18 warns on a singular product
            warnings.simplefilter("ignore")
            covmean = scipy.linalg.sqrtm(cov1 @ cov2)
        if not np.isfinite(covmean).all():
            raise np.linalg.LinAlgError("non-finite sqrtm")
        tr_covmean = float(np.trace(np.real(covmean)))
    except (np.linalg.LinAlgError, ValueError):
        evals = np.linalg.eigvals(cov1 @ cov2)
        tr_covmean = float(np.sum(np.sqrt(np.maximum(evals.real, 0.0))))
    return float(diff @ diff + np.trace(cov1 + cov2) - 2 * tr_covmean)


class ConditionalFID:
    """Per-class FID: ``sfid`` (the mean of the per-class FIDs), ``rfid``
    (the FID of the class means) and ``agg`` (the moments pooled over the
    classes)."""

    def __init__(self, feature_fn: Callable, max_items_per_class: Optional[int] = None):
        self.feature_fn = feature_fn
        self.max_items = max_items_per_class
        self.real: Dict[int, FeatureStats] = {}
        self.fake: Dict[int, FeatureStats] = {}

    def _append(self, store: Dict[int, FeatureStats], cls: int, images) -> None:
        feats = np.asarray(self.feature_fn(images))
        store.setdefault(cls, FeatureStats(max_items=self.max_items)).append(feats)

    def append_real(self, cls: int, images) -> None:
        self._append(self.real, cls, images)

    def append_fake(self, cls: int, images) -> None:
        self._append(self.fake, cls, images)

    def save_real_stats(self, path) -> None:
        """Write the real side's per-class moments (``sum_{c}``,
        ``outer_{c}``, ``num_{c}``) to an ``.npz``, through a temporary file."""
        for cls in sorted(self.real):
            self.real[cls].sync_across_hosts()
        arrays = {}
        for cls, st in self.real.items():
            if st._sum is None:
                continue
            arrays[f"sum_{cls}"] = st._sum
            arrays[f"outer_{cls}"] = st._outer
            arrays[f"num_{cls}"] = np.array(st.num, np.int64)
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, **arrays)
        tmp.replace(path)

    def load_real_stats(self, path) -> bool:
        """Read cached real-side moments; True if the file exists. They
        count as synced."""
        path = Path(path)
        if not path.exists():
            return False
        with np.load(path) as z:
            for cls in sorted({int(k.split("_", 1)[1]) for k in z.files}):
                st = FeatureStats(max_items=self.max_items)
                st._sum = z[f"sum_{cls}"]
                st._outer = z[f"outer_{cls}"]
                st.num = int(z[f"num_{cls}"])
                st.dim = st._sum.shape[0]
                st._synced = True
                self.real[cls] = st
        return True

    def _sync_stores(self) -> None:
        """Every class's moments summed over the ranks: nothing to do in one
        process; raises under a process group of more than one rank."""
        _refuse_many_ranks("ConditionalFID")
        for store in (self.real, self.fake):
            for cls in sorted(store):
                store[cls].sync_across_hosts()

    def compute(self, mode: str = "agg") -> float:
        self._sync_stores()
        classes = sorted(set(self.real) & set(self.fake))
        if not classes:
            raise ValueError("no class has both real and fake statistics")
        if mode == "sfid":
            fids = [frechet_distance(*self.real[c].get_mean_cov(), *self.fake[c].get_mean_cov())
                    for c in classes]
            return float(np.mean(fids))
        if mode == "rfid":
            s_r, s_f = FeatureStats(), FeatureStats()
            s_r.append(np.stack([self.real[c].get_mean_cov()[0] for c in classes]))
            s_f.append(np.stack([self.fake[c].get_mean_cov()[0] for c in classes]))
            return frechet_distance(*s_r.get_mean_cov(), *s_f.get_mean_cov())
        if mode == "agg":
            s_r, s_f = FeatureStats(), FeatureStats()
            for c in classes:
                for pooled, st in ((s_r, self.real[c]), (s_f, self.fake[c])):
                    if pooled._sum is None:
                        pooled._sum = np.zeros_like(st._sum)
                        pooled._outer = np.zeros_like(st._outer)
                    pooled.num += st.num
                    pooled._sum += st._sum
                    pooled._outer += st._outer
            return frechet_distance(*s_r.get_mean_cov(), *s_f.get_mean_cov())
        raise ValueError(f"unknown FID mode {mode}")


class ConditionalMetrics:
    """Named data splits (class → real images) and named metrics (FID
    modes), each metric evaluated on a split. With ``cache_dir``, a split's
    real moments are computed once and read back on every later evaluation
    (`stats_cache_file`)."""

    def __init__(self, feature_fn: Callable, cache_dir=None, detector_name: str = "features"):
        self.feature_fn = feature_fn
        self.splits: Dict[str, dict] = {}
        self.metrics: Dict[str, str] = {}
        self.cache_dir = cache_dir
        self.detector_name = detector_name
        self._split_config: Dict[str, dict] = {}

    def add_split(self, name: str, class_to_real: Dict[int, np.ndarray],
                  config: Optional[dict] = None) -> None:
        """class id → real images (NHWC, [−1, 1]). ``config`` enters the
        cache's name: pass whatever must make a new entry when it changes."""
        self.splits[name] = class_to_real
        self._split_config[name] = dict(config or {})

    def add_metric(self, name: str, mode: str = "agg") -> None:
        if mode not in ("agg", "sfid", "rfid"):
            raise ValueError(f"unknown FID mode {mode}")
        self.metrics[name] = mode

    def _cache_file(self, split: str, per_class: Optional[int]):
        if self.cache_dir is None:
            return None
        config = dict(self._split_config.get(split, {}))
        config["max_items_per_class"] = per_class
        return stats_cache_file(self.cache_dir, split, self.detector_name, config)

    def calc_metric(self, metric: str, split: str, generate_fn,
                    per_class: Optional[int] = None) -> float:
        """``generate_fn(cls, count)`` → that class's fake NHWC batch."""
        mode = self.metrics[metric]
        fid = ConditionalFID(self.feature_fn, max_items_per_class=per_class)
        cache = self._cache_file(split, per_class)
        cached = cache is not None and fid.load_real_stats(cache)
        for cls, real in self.splits[split].items():
            if not cached:
                fid.append_real(cls, real)
            fid.append_fake(cls, generate_fn(cls, len(real)))
        if cache is not None and not cached:
            fid.save_real_stats(cache)
        return fid.compute(mode)

    def report_metrics(self, split: str, generate_fn) -> Dict[str, float]:
        return {m: self.calc_metric(m, split, generate_fn) for m in self.metrics}
