"""Class-consistent multi-set data sampling for SetGAN (host only).

A copy of the JAX package's `setgan/dataset.py` (reference setgan/dataset.py
and safe_dataset.py): `ClassImageDataset` (class folders, filename
prefixes, CelebA attribute or identity lists, zip archives),
`SafeClassImageDataset` (an image that fails to decode is replaced by
another of its class), `ImageMultiSetGenerator` (class-consistent
reference and candidate sets padded to the maxima with masks, flips, a
set-consistent rotation, the contrastive draw, a `RandomState` per shard)
and `build_datasets`' named layouts. It draws from the same
`np.random.RandomState` calls in the same order, so both packages give
identical batches from one seed. PIL and scipy are imported where an image
is read or rotated.
"""

from __future__ import annotations

import io
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.images_dataset import IMG_EXTENSIONS


class ClassImageDataset:
    """class id → image paths; loads float32 NHWC in [-1, 1]."""

    def __init__(self, class_to_paths: Dict[int, List[Path]], resolution: int):
        self.class_to_paths = {k: list(v) for k, v in class_to_paths.items()
                               if len(v) > 0}
        self.classes = sorted(self.class_to_paths)
        self.resolution = resolution

    @classmethod
    def from_folder(cls, root, resolution: int = 256) -> "ClassImageDataset":
        """Each immediate subdirectory is a class; flat folders = 1 class.
        `.zip` archives load via `from_zip` (the reference's dataset2.py
        zip-backed variant)."""
        root = Path(root)
        if root.suffix.lower() == ".zip":
            return cls.from_zip(root, resolution)
        subdirs = [d for d in sorted(root.iterdir()) if d.is_dir()]
        mapping: Dict[int, List[Path]] = {}
        if subdirs:
            for i, d in enumerate(subdirs):
                mapping[i] = [p for p in sorted(d.rglob("*"))
                              if p.suffix.lower() in IMG_EXTENSIONS]
        else:
            mapping[0] = [p for p in sorted(root.iterdir())
                          if p.suffix.lower() in IMG_EXTENSIONS]
        return cls(mapping, resolution)

    @classmethod
    def from_category_prefix(cls, root, resolution: int = 256
                             ) -> "ClassImageDataset":
        """Category = filename prefix before the first underscore (the
        reference's `from_folder_by_category`, setgan/dataset.py:139-148 —
        used by vggface/animalfaces/flowers/cifar100/mini-imagenet)."""
        root = Path(root)
        paths = [p for p in sorted(root.rglob("*"))
                 if p.suffix.lower() in IMG_EXTENSIONS]
        cats: Dict[str, List[Path]] = {}
        for p in paths:
            cats.setdefault(p.name.split("_")[0], []).append(p)
        return cls({i: v for i, (_, v) in enumerate(sorted(cats.items()))},
                   resolution)

    @classmethod
    def from_attributes(cls, src_path, attr_path, resolution: int = 256
                        ) -> "ClassImageDataset":
        """CelebA-style attribute annotations: one class per attribute
        column; an image joins every class whose flag is +1 (reference
        `from_folder_by_attributes`, setgan/dataset.py:150-189). Classes may
        overlap — `class_to_paths` lists are independent."""
        src = Path(src_path)
        with open(attr_path) as f:
            lines = f.read().splitlines()
        lines = [l for l in lines if l.strip()]
        categories = lines[1].split()
        mapping: Dict[int, List[Path]] = {i: [] for i in range(len(categories))}
        for line in lines[2:]:
            tokens = line.split()
            img = src / tokens[0]
            flags = np.array([int(t) for t in tokens[1:]])
            for i in np.where(flags == 1)[0]:
                mapping[int(i)].append(img)
        ds = cls(mapping, resolution)
        ds.class_names = categories
        return ds

    @classmethod
    def from_identities(cls, src_path, ident_path, resolution: int = 256
                        ) -> "ClassImageDataset":
        """CelebA-style identity annotations: `<image> <identity>` lines,
        one class per identity (reference `from_folder_by_identities`,
        setgan/dataset.py:191-226)."""
        src = Path(src_path)
        mapping: Dict[int, List[Path]] = {}
        with open(ident_path) as f:
            for line in f:
                tokens = line.split()
                if len(tokens) < 2:
                    continue
                mapping.setdefault(int(tokens[1]) - 1, []).append(
                    src / tokens[0])
        return cls(mapping, resolution)

    def split_val(self, val_frac: float, randomize: bool = False,
                  seed: Optional[int] = None
                  ) -> Tuple["ClassImageDataset", "ClassImageDataset"]:
        """(val, train) split BY CLASS (reference `split_datasets`,
        setgan/dataset.py:370-379: the first val_frac of the class list)."""
        classes = list(self.classes)
        if randomize:
            np.random.RandomState(seed).shuffle(classes)
        n_val = int(val_frac * len(classes))
        val = {c: self.class_to_paths[c] for c in classes[:n_val]}
        train = {c: self.class_to_paths[c] for c in classes[n_val:]}
        mk = type(self)
        a, b = mk(val, self.resolution), mk(train, self.resolution)
        a._zip = b._zip = self._zip
        return a, b

    class_names: Optional[List[str]] = None  # set by from_attributes

    @classmethod
    def from_zip(cls, path, resolution: int = 256) -> "ClassImageDataset":
        """Zip-backed dataset: top-level archive directories are classes."""
        zf = zipfile.ZipFile(path)
        mapping: Dict[int, List[str]] = {}
        class_names: Dict[str, int] = {}
        for name in sorted(zf.namelist()):
            if not any(name.lower().endswith(e) for e in IMG_EXTENSIONS):
                continue
            cls_name = name.split("/")[0] if "/" in name else ""
            if cls_name not in class_names:
                class_names[cls_name] = len(class_names)
            mapping.setdefault(class_names[cls_name], []).append(name)
        ds = cls(mapping, resolution)
        ds._zip = zf
        return ds

    _zip = None  # set by from_zip

    def load(self, path) -> np.ndarray:
        from PIL import Image

        if self._zip is not None:
            with self._zip.open(str(path)) as f:
                im = Image.open(io.BytesIO(f.read()))
        else:
            im = Image.open(path)
        im = im.convert("RGB").resize(
            (self.resolution, self.resolution), Image.BILINEAR)
        return np.asarray(im, np.float32) / 127.5 - 1.0

    def num_images(self) -> int:
        return sum(len(v) for v in self.class_to_paths.values())


class SafeClassImageDataset(ClassImageDataset):
    """Skips samples that fail to decode, resampling within the class
    (parity: setgan/safe_dataset.py index-skipping)."""

    def load(self, path: Path) -> np.ndarray:
        try:
            return super().load(path)
        except Exception:
            pass
        # Fall back to any decodable image of the same class.
        for cls_paths in self.class_to_paths.values():
            if path in cls_paths:
                for alt in cls_paths:
                    if alt == path:
                        continue
                    try:
                        return super().load(alt)
                    except Exception:
                        continue
        raise RuntimeError(f"no decodable image near {path}")


class ImageMultiSetGenerator:
    """Infinite sampler of (reference_set, candidate_set, masks) batches.

    Reference/candidate sizes are drawn uniformly in [r_min, r_max] /
    [c_min, c_max] per batch element, padded to the maxima with masks.
    `shard`/`num_shards` split the RNG stream across hosts
    (setgan/dataset.py:456 rank/world_size).
    """

    def __init__(self, dataset: ClassImageDataset, batch_size: int,
                 reference_range: Tuple[int, int] = (7, 12),
                 candidate_range: Tuple[int, int] = (1, 4),
                 flip_augment: bool = True,
                 data_augmentation: bool = False,
                 rotation_fill: float = 0.0,
                 shard: int = 0, num_shards: int = 1, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.r_min, self.r_max = reference_range
        self.c_min, self.c_max = candidate_range
        self.flip_augment = flip_augment
        self.data_augmentation = data_augmentation
        self.rotation_fill = rotation_fill
        self.rng = np.random.RandomState(seed * num_shards + shard)

    def _sample_class_set(self, cls: int, count: int) -> List[np.ndarray]:
        paths = self.ds.class_to_paths[cls]
        replace = len(paths) < count
        idx = self.rng.choice(len(paths), size=count, replace=replace)
        imgs = [self.ds.load(paths[i]) for i in idx]
        if self.flip_augment and not self.data_augmentation:
            imgs = [im[:, ::-1] if self.rng.rand() < 0.5 else im for im in imgs]
        return imgs

    def _augment_set(self, imgs: List[np.ndarray]) -> List[np.ndarray]:
        """Set-CONSISTENT augmentation: one random transform chain applied to
        every image of a batch element's sets (reference `_augment_sets`,
        setgan/dataset.py:470-484: 50% flip — 50/50 vertical/horizontal —
        then 50% rotation by a uniform angle with constant fill)."""
        ops = []
        if self.rng.rand() < 0.5:
            if self.rng.rand() < 0.5:
                ops.append(lambda im: im[::-1])         # vertical flip
            else:
                ops.append(lambda im: im[:, ::-1])      # horizontal flip
        if self.rng.rand() < 0.5:
            from scipy.ndimage import rotate
            angle = float(self.rng.rand() * 360)
            ops.append(lambda im: rotate(
                im, angle, reshape=False, order=1, mode="constant",
                cval=self.rotation_fill))
        out = []
        for im in imgs:
            for op in ops:
                im = op(im)
            out.append(np.ascontiguousarray(im, np.float32))
        return out

    def sample_batch(self, contrastive: bool = False):
        """→ dict(reference [B,Rmax,H,W,3], candidate [B,Cmax,H,W,3],
        ref_mask [B,Rmax], cand_mask [B,Cmax], classes [B]); with
        ``contrastive`` also contrastive_reference/_mask/_classes from
        guaranteed-different classes (reference dataset.py:545-566)."""
        res = self.ds.resolution
        b = self.batch_size
        r_sizes = self.rng.randint(self.r_min, self.r_max + 1, size=b)
        c_sizes = self.rng.randint(self.c_min, self.c_max + 1, size=b)
        reference = np.zeros((b, self.r_max, res, res, 3), np.float32)
        candidate = np.zeros((b, self.c_max, res, res, 3), np.float32)
        ref_mask = np.zeros((b, self.r_max), bool)
        cand_mask = np.zeros((b, self.c_max), bool)
        classes = self.rng.choice(self.ds.classes, size=b)
        for i, cls in enumerate(classes):
            imgs = self._sample_class_set(int(cls), r_sizes[i] + c_sizes[i])
            if self.data_augmentation:
                imgs = self._augment_set(imgs)
            reference[i, :r_sizes[i]] = imgs[:r_sizes[i]]
            candidate[i, :c_sizes[i]] = imgs[r_sizes[i]:]
            ref_mask[i, :r_sizes[i]] = True
            cand_mask[i, :c_sizes[i]] = True
        batch = {"reference": reference, "candidate": candidate,
                 "ref_mask": ref_mask, "cand_mask": cand_mask,
                 "classes": classes}
        if contrastive:
            assert len(self.ds.classes) > 1, "contrastive needs >1 class"
            con = np.array([self.rng.choice(
                [c for c in self.ds.classes if c != cls])
                for cls in classes])
            con_ref = np.zeros_like(reference)
            con_mask = np.zeros_like(ref_mask)
            for i, cls in enumerate(con):
                imgs = self._sample_class_set(int(cls), r_sizes[i])
                if self.data_augmentation:
                    imgs = self._augment_set(imgs)
                con_ref[i, :r_sizes[i]] = imgs
                con_mask[i, :r_sizes[i]] = True
            batch["contrastive_reference"] = con_ref
            batch["contrastive_mask"] = con_mask
            batch["contrastive_classes"] = con
        return batch

    def __iter__(self):
        while True:
            yield self.sample_batch()


# ------------------------------------------------- per-dataset wiring

def build_datasets(name: str, data_root, resolution: int,
                   val_frac: float = 0.1, paths: Optional[dict] = None
                   ) -> Tuple[ClassImageDataset, ClassImageDataset]:
    """(eval_ds, train_ds) for the reference's named datasets
    (setgan/dataset.py:309-366 / train_setgan.py --dataset).

    Layout conventions per dataset under ``data_root`` (override any path
    via ``paths``):
      celeba / face   — img_align_celeba/ + list_attr_celeba.txt (by attrs)
      celeba-ident    — img_align_celeba/ + identity_CelebA.txt (by identity)
      imagenet        — one subfolder per class (train/val split by class)
      vggface, animalfaces, flowers, cifar100, mini-imagenet —
                        <name>/train + <name>/test, category = filename
                        prefix before '_'
    """
    root = Path(data_root)
    p = paths or {}

    def at(key, default):
        return Path(p.get(key, root / default))

    if name in ("celeba", "face"):
        ds = ClassImageDataset.from_attributes(
            at("src", "img_align_celeba"),
            at("attr", "list_attr_celeba.txt"), resolution)
        return ds.split_val(val_frac)
    if name == "celeba-ident":
        ds = ClassImageDataset.from_identities(
            at("src", "img_align_celeba"),
            at("ident", "identity_CelebA.txt"), resolution)
        return ds.split_val(val_frac)
    if name == "imagenet":
        ds = ClassImageDataset.from_folder(at("src", "imagenet"), resolution)
        return ds.split_val(val_frac)
    if name in ("vggface", "animalfaces", "flowers", "cifar100",
                "mini-imagenet"):
        train = ClassImageDataset.from_category_prefix(
            at("train", f"{name}/train"), resolution)
        test = ClassImageDataset.from_category_prefix(
            at("test", f"{name}/test"), resolution)
        return test, train
    raise ValueError(f"unknown dataset {name!r}")
