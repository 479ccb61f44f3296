"""Folder-backed image datasets + infinite sharded batching.

A copy of the JAX package's `data/images_dataset.py` (reference
inversion/datasets/images_dataset.py: source/target pairs, the source
falling back to the target when untransformed; and
torch_utils/misc.InfiniteSampler: `BatchIterator(shard, num_shards)` splits
the index space across hosts), with PIL imported where an image is read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp", ".tiff"}


def make_dataset(root) -> List[Path]:
    """Recursively list image files under root (sorted)."""
    root = Path(root)
    paths = [p for p in sorted(root.rglob("*"))
             if p.suffix.lower() in IMG_EXTENSIONS]
    if not paths:
        raise FileNotFoundError(f"no images found under {root}")
    return paths


class ImagesDataset:
    """(source, target) image pairs as float32 NHWC arrays in [-1, 1]."""

    def __init__(self, source_root, target_root,
                 source_transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None):
        self.source_paths = make_dataset(source_root)
        self.target_paths = make_dataset(target_root)
        self.source_transform = source_transform
        self.target_transform = target_transform

    def __len__(self):
        return len(self.source_paths)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        from_im = Image.open(self.source_paths[index]).convert("RGB")
        to_im = Image.open(self.target_paths[index]).convert("RGB")
        if self.target_transform:
            to_im = self.target_transform(to_im)
        if self.source_transform:
            from_im = self.source_transform(from_im)
        else:
            from_im = to_im
        return from_im, to_im


class BatchIterator:
    """Infinite shuffled batch iterator with per-host sharding.

    `shard`/`num_shards` split the index space across hosts the way the
    reference's InfiniteSampler splits across ranks. `shuffle_window`-free:
    full reshuffle per epoch (datasets are folder-sized, not streamed).
    """

    def __init__(self, dataset, batch_size: int, shard: int = 0,
                 num_shards: int = 1, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True):
        assert 0 <= shard < num_shards
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx[self.shard::self.num_shards]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            idx = self._epoch_indices()
            limit = (len(idx) // self.batch_size * self.batch_size
                     if self.drop_last else len(idx))
            for start in range(0, limit, self.batch_size):
                items = [self.dataset[int(i)]
                         for i in idx[start:start + self.batch_size]]
                xs = np.stack([it[0] for it in items])
                ys = np.stack([it[1] for it in items])
                yield xs, ys

    def epoch_batches(self, max_batches: Optional[int] = None):
        """One pass over the (sharded) dataset — for validation loops."""
        idx = np.arange(len(self.dataset))[self.shard::self.num_shards]
        count = 0
        for start in range(0, len(idx) - self.batch_size + 1, self.batch_size):
            if max_batches is not None and count >= max_batches:
                return
            items = [self.dataset[int(i)]
                     for i in idx[start:start + self.batch_size]]
            yield (np.stack([it[0] for it in items]),
                   np.stack([it[1] for it in items]))
            count += 1
