"""The port's native batch preprocessor (`data/native.py`) against the JAX
package's and its own numpy version, on the CPU.

The library builds with ``g++`` from the unchanged
``native/batch_preprocess.cpp`` into the port's ``_build/``; the port
raises where the build fails instead of falling back. Tolerance: equal
(both packages run the same C++; the numpy version's ``x·(2/255) − 1`` is
the kernel's float32 arithmetic).
"""

import numpy as np
import pytest

from stylegan3_editing_tpu.data import native as jnative
from stylegan3_editing_tpu_torch.data import native


@pytest.mark.parametrize("shape,flip", [((3, 17, 23, 3), [1, 0, 1]), ((2, 8, 8, 3), None),
                                        ((5, 1, 31, 4), [0, 0, 1, 1, 0])])
def test_normalize_batch_matches_jax(shape, flip):
    imgs = np.random.RandomState(sum(shape)).randint(0, 256, shape, dtype=np.uint8)
    flip = None if flip is None else np.array(flip, np.uint8)
    got = native.normalize_batch(imgs, flip, num_threads=2)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, jnative.normalize_batch(imgs, flip, num_threads=2))
    np.testing.assert_array_equal(got, native.normalize_batch(imgs, flip, impl="numpy"))
    assert got.min() >= -1.0 and got.max() <= 1.0


def test_library_is_keyed_by_the_source_and_a_failed_build_raises(tmp_path, monkeypatch):
    path = native.library_path()
    native.get_library()
    assert path.exists() and path.parent.name == "_build"
    bad = tmp_path / "batch_preprocess.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    assert native.library_path() != path
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.normalize_batch(np.zeros((1, 2, 2, 3), np.uint8))
    with pytest.raises(ValueError):
        native.normalize_batch(np.zeros((1, 2, 2, 3), np.uint8), impl="fast")
