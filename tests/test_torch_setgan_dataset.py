"""The port's SetGAN data sampling against the JAX package's, on the CPU.

Both packages read the same seeded PNGs (class folders, filename prefixes,
CelebA-style attribute and identity lists, a zip archive) and draw from one
seed: the class maps, every batch array (reference and candidate sets,
masks, classes, the contrastive draw) and the skipped corrupt images must
be identical, byte for byte.
"""

import zipfile

import numpy as np
import pytest
from PIL import Image

from stylegan3_editing_tpu.setgan import dataset as jds
from stylegan3_editing_tpu_torch.setgan import dataset as tds

RES = 16
CLASSES = ("cat", "dog", "owl")


def _png(path, seed):
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 256, (20, 24, 3), dtype=np.uint8)).save(path)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("setgan_data")
    seed = 0
    for ci, name in enumerate(CLASSES):
        for i in range(3 + ci):
            seed += 1
            _png(root / "folders" / name / f"{i}.png", seed)
            _png(root / "flowers" / "train" / f"{name}_{i}.png", seed)
            _png(root / "flowers" / "test" / f"{name}_{i}.png", seed + 100)
    (root / "folders" / "dog" / "notes.txt").write_text("not an image")
    with zipfile.ZipFile(root / "data.zip", "w") as zf:
        for p in sorted((root / "folders").rglob("*.png")):
            zf.write(p, str(p.relative_to(root / "folders")))
    celeba = root / "celeba" / "img_align_celeba"
    names = [f"{i:06d}.jpg" for i in range(1, 9)]
    for i, n in enumerate(names):
        celeba.mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.random.RandomState(200 + i).randint(
            0, 256, (20, 20, 3), dtype=np.uint8)).save(celeba / n)
    flags = np.random.RandomState(7).choice([-1, 1], size=(len(names), 4))
    lines = [str(len(names)), "Smiling Young Male Bangs"]
    lines += [f"{n} " + " ".join(str(f) for f in row) for n, row in zip(names, flags)]
    (root / "celeba" / "list_attr_celeba.txt").write_text("\n".join(lines) + "\n")
    (root / "celeba" / "identity_CelebA.txt").write_text(
        "".join(f"{n} {1 + i % 3}\n" for i, n in enumerate(names)))
    for sub in ("train",):
        for i, name in enumerate(CLASSES):
            _png(root / "imagenet" / name / f"{sub}{i}.png", 300 + i)
            _png(root / "imagenet" / name / f"{sub}{i}b.png", 310 + i)
    return root


def _same_dataset(a, b):
    assert a.classes == b.classes and a.resolution == b.resolution
    assert {k: list(map(str, v)) for k, v in a.class_to_paths.items()} == \
        {k: list(map(str, v)) for k, v in b.class_to_paths.items()}
    assert a.class_names == b.class_names


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


@pytest.mark.parametrize("source", ["folders", "data.zip"])
@pytest.mark.parametrize("options", [
    dict(), dict(flip_augment=False), dict(data_augmentation=True, rotation_fill=-1.0),
    dict(shard=1, num_shards=2, seed=3)], ids=["plain", "noflip", "augmented", "sharded"])
def test_multiset_batches_match_jax(roots, source, options):
    jd = jds.ClassImageDataset.from_folder(roots / source, RES)
    td = tds.ClassImageDataset.from_folder(roots / source, RES)
    _same_dataset(jd, td)
    kw = dict(reference_range=(2, 4), candidate_range=(1, 2), **options)
    jg = jds.ImageMultiSetGenerator(jd, 3, **kw)
    tg = tds.ImageMultiSetGenerator(td, 3, **kw)
    for contrastive in (False, True, False):
        _same_batch(jg.sample_batch(contrastive), tg.sample_batch(contrastive))
    _same_batch(next(iter(jg)), next(iter(tg)))


def test_batch_layout(roots):
    ds = tds.ClassImageDataset.from_folder(roots / "folders", RES)
    b = tds.ImageMultiSetGenerator(ds, 4, reference_range=(2, 5), candidate_range=(1, 3),
                                   seed=1).sample_batch(contrastive=True)
    assert b["reference"].shape == (4, 5, RES, RES, 3) and b["candidate"].shape == (4, 3, RES,
                                                                                       RES, 3)
    for i in range(4):
        r, c = b["ref_mask"][i].sum(), b["cand_mask"][i].sum()
        assert 2 <= r <= 5 and 1 <= c <= 3
        assert not b["reference"][i, r:].any() and not b["candidate"][i, c:].any()
        assert b["contrastive_classes"][i] != b["classes"][i]
        assert b["contrastive_mask"][i].sum() == r


def test_safe_dataset_skips_corrupt_images(roots, tmp_path):
    bad_root = tmp_path / "bad"
    for name in ("a", "b"):
        for i in range(3):
            _png(bad_root / name / f"{i}.png", 50 + i)
    (bad_root / "a" / "1.png").write_bytes(b"not a png")
    jd = jds.SafeClassImageDataset.from_folder(bad_root, RES)
    td = tds.SafeClassImageDataset.from_folder(bad_root, RES)
    bad = td.class_to_paths[0][1]
    np.testing.assert_array_equal(td.load(bad), jd.load(bad))
    np.testing.assert_array_equal(td.load(bad), td.load(td.class_to_paths[0][0]))
    with pytest.raises(Exception):
        tds.ClassImageDataset.from_folder(bad_root, RES).load(bad)
    kw = dict(reference_range=(3, 3), candidate_range=(1, 1), seed=2)
    _same_batch(jds.ImageMultiSetGenerator(jd, 4, **kw).sample_batch(),
                tds.ImageMultiSetGenerator(td, 4, **kw).sample_batch())


@pytest.mark.parametrize("name", ["celeba", "celeba-ident", "imagenet", "flowers"])
def test_build_datasets_layouts_match_jax(roots, name):
    sub = {"celeba": "celeba", "celeba-ident": "celeba"}.get(name, "")
    jv, jt = jds.build_datasets(name, roots / sub if sub else roots, RES, val_frac=0.34)
    tv, tt = tds.build_datasets(name, roots / sub if sub else roots, RES, val_frac=0.34)
    _same_dataset(jv, tv)
    _same_dataset(jt, tt)
    assert tt.classes
    with pytest.raises(ValueError):
        tds.build_datasets("nope", roots, RES)


def test_split_val_randomized_matches_jax(roots):
    jd = jds.ClassImageDataset.from_category_prefix(roots / "flowers" / "train", RES)
    td = tds.ClassImageDataset.from_category_prefix(roots / "flowers" / "train", RES)
    for a, b in zip(jd.split_val(0.5, randomize=True, seed=4),
                    td.split_val(0.5, randomize=True, seed=4)):
        _same_dataset(a, b)
