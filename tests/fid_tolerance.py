"""Derive `chip_smoke.FID_CARD_TOL` on the CPU: how far the FID moves when the
features move by as much as phase 17's feature gate allows.

The seeded InceptionV3 of `inception_feature_fn` (the phase's network) takes
two sets of 16 smooth 256² images; their features are moved by uniform
noise of 1e-6, 1e-5 and 1e-4 (`EVAL_TOL`) of their max |value|, and the
relative change of the FID of the two sets is printed for two draws each,
with a set's FID against itself as a share of its 2 tr(cov). Each 2048-d
`sqrtm` takes some 20 s here, so this is a script, not a test:

    python tests/fid_tolerance.py
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from stylegan3_editing_tpu_torch.models.backbones.inception import (  # noqa: E402
    inception_feature_fn)
from stylegan3_editing_tpu_torch.setgan.metrics import (  # noqa: E402
    FeatureStats, frechet_distance)


def images(seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    base = torch.from_numpy(rng.randn(16, 8, 8, 3).astype(np.float32)).permute(0, 3, 1, 2)
    smooth = torch.nn.functional.interpolate(base, size=256, mode="bilinear")
    return np.tanh(smooth.permute(0, 2, 3, 1).numpy()
                   + 0.3 * rng.randn(16, 256, 256, 3).astype(np.float32))


def fid(a: np.ndarray, b: np.ndarray) -> float:
    s1, s2 = FeatureStats(), FeatureStats()
    s1.append(a)
    s2.append(b)
    return frechet_distance(*s1.get_mean_cov(), *s2.get_mean_cov())


def main() -> None:
    features = inception_feature_fn(device="cpu")
    real, fake = features(images(1)), features(images(2))
    scale = max(float(np.abs(real).max()), float(np.abs(fake).max()))
    base = fid(real, fake)
    print(f"features max |value| {scale:.6g}; FID {base!r}")
    for rel in (1e-6, 1e-5, 1e-4):
        for draw in range(2):
            rng = np.random.RandomState(10 + draw)
            moved = fid(real + rel * scale * rng.uniform(-1, 1, real.shape),
                        fake + rel * scale * rng.uniform(-1, 1, fake.shape))
            print(f"features moved by {rel:g} of max: FID {moved!r}, relative change "
                  f"{abs(moved - base) / base:.3e}")
    st = FeatureStats()
    st.append(real)
    mu, cov = st.get_mean_cov()
    self_fid = frechet_distance(mu, cov, mu, cov)
    print(f"a set against itself: {self_fid!r}, {self_fid / (2 * np.trace(cov)):.3e} of its "
          f"2 tr(cov)")


if __name__ == "__main__":
    main()
