"""Device prefetcher: keep the input pipeline ahead of the train step.

Counterpart of the JAX package's `data/prefetch.py` (the reference hides
input latency behind DataLoader workers, setgan/training_loop.py and
torch_utils/misc.py:113-147): a daemon thread stays ``depth`` batches ahead
of the consumer, running both the host-side batch assembly (``next(it)``)
and the host → device placement (``place_fn``) while the current step
runs. `to_device` is the coach's ``place_fn``: on the card it copies from
pinned memory with ``non_blocking=True`` and keeps the pinned sources in
the placed batch, so they live until the batch is consumed.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple, TypeVar

import numpy as np
import torch

T = TypeVar("T")

_SENTINEL = object()


class DevicePrefetcher:
    """Wrap a batch iterator; apply `place_fn` up to `depth` batches ahead.

    Exceptions in the producer (including from `place_fn`) re-raise at the
    consumer's next `__next__`. Exhaustion propagates as StopIteration.
    `close()` stops the thread.
    """

    def __init__(self, it: Iterator[T], place_fn: Callable[[T], T], depth: int = 2):
        assert depth >= 1
        self._it = iter(it)
        self._place = place_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for item in self._it:
                placed = self._place(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(placed, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 (re-raised at the consumer)
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()
        # Drain so a blocked producer can observe the stop flag.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def maybe_prefetch(it: Iterator[T], place_fn: Callable[[T], T],
                   depth: Optional[int]) -> Iterator[T]:
    """`depth` ≥ 1 → DevicePrefetcher; 0/None → place inline (no thread)."""
    if depth:
        return DevicePrefetcher(it, place_fn, depth=depth)
    return (place_fn(b) for b in it)


def to_device(device: torch.device) -> Callable[[Tuple[np.ndarray, ...]], tuple]:
    """``place_fn`` for (x, y) numpy batches: float32 tensors on ``device``;
    on the card, copied from pinned memory without blocking, the pinned
    sources kept as the batch's third element."""

    def place(batch):
        hosts = [torch.from_numpy(np.ascontiguousarray(b, dtype=np.float32)) for b in batch]
        if device.type != "cuda":
            return tuple(h.to(device) for h in hosts)
        pinned = [h.pin_memory() for h in hosts]
        return (*(p.to(device, non_blocking=True) for p in pinned), pinned)

    return place
