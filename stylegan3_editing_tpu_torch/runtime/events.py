"""TensorBoard-format event writing, image grids and module summaries.

A copy of the JAX package's `runtime/events.py` (SURVEY §5: TensorBoard
scalar and image events, reference setgan/training_loop.py:349-362 and the
inversion coaches :277-319; image grids; `print_module_summary`,
torch_utils/misc.py:198). The writer needs no TensorFlow: it serialises by
hand the part of the TF `Event` proto TensorBoard reads (wall_time, step,
summary.value{tag, simple_value | image}) in TFRecord framing (length and
masked crc32c). numpy and `struct` only; PIL is imported where a PNG is
encoded. `module_summary` counts an `nn.Module`'s parameters.
"""

from __future__ import annotations

import io
import struct
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# ------------------------------------------------------------------ crc32c

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --------------------------------------------------------- proto encoding


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f_bytes(num: int, data: bytes) -> bytes:
    return _field(num, 2) + _varint(len(data)) + data


def _f_varint(num: int, value: int) -> bytes:
    return _field(num, 0) + _varint(value)


def _f_double(num: int, value: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", value)


def _f_float(num: int, value: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", value)


def _png_bytes(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


class EventWriter:
    """Append TensorBoard events to `logdir/events.out.tfevents.*`."""

    def __init__(self, logdir):
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        self.path = logdir / f"events.out.tfevents.{int(time.time())}.sg3tpu"
        self._f = open(self.path, "ab")
        # File header event (version marker).
        self._write_event(_f_double(1, time.time())
                          + _f_bytes(3, b"brain.Event:2"))

    def _write_event(self, event_bytes: bytes):
        header = struct.pack("<Q", len(event_bytes))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event_bytes)
        self._f.write(struct.pack("<I", _masked_crc(event_bytes)))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int):
        val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
        summary = _f_bytes(1, val)
        self._write_event(_f_double(1, time.time()) + _f_varint(2, step)
                          + _f_bytes(5, summary))

    def scalars(self, values: Dict[str, float], step: int):
        for tag, v in values.items():
            if isinstance(v, (int, float)) and np.isfinite(v):
                self.scalar(tag, float(v), step)

    def image(self, tag: str, img: np.ndarray, step: int):
        """img: [H, W, 3] uint8 or float in [-1, 1]."""
        img = to_uint8(img)
        png = _png_bytes(img)
        image_msg = (_f_varint(1, img.shape[0]) + _f_varint(2, img.shape[1])
                     + _f_varint(3, 3) + _f_bytes(4, png))
        val = _f_bytes(1, tag.encode()) + _f_bytes(4, image_msg)
        summary = _f_bytes(1, val)
        self._write_event(_f_double(1, time.time()) + _f_varint(2, step)
                          + _f_bytes(5, summary))

    def close(self):
        self._f.close()


# ------------------------------------------------------------ image grids


def to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)
    return img


def make_grid(images: np.ndarray, cols: Optional[int] = None) -> np.ndarray:
    """[N, H, W, 3] (float [-1,1] or uint8) → one [gh·H, gw·W, 3] uint8
    grid (the reference's snapshot grids, setgan/training_loop.py:86-121)."""
    images = to_uint8(images)
    n, h, w, c = images.shape
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    return grid


def save_image_grid(images: np.ndarray, path, cols: Optional[int] = None):
    from PIL import Image

    grid = make_grid(images, cols)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(grid).save(path)
    return grid


# --------------------------------------------------------- module summary


def module_summary(module, max_depth: int = 2) -> str:
    """Parameter-count table per submodule of an `nn.Module`
    (print_module_summary analogue, reference torch_utils/misc.py:198-268)."""
    rows: Dict[str, int] = {}
    total = 0
    for name, p in module.named_parameters():
        key = "/".join(name.split(".")[:max_depth])
        rows[key] = rows.get(key, 0) + p.numel()
        total += p.numel()
    width = max([len(k) for k in rows] + [9])
    lines = [f"{'module':<{width}s}  {'params':>12s}"]
    for name in sorted(rows):
        lines.append(f"{name:<{width}s}  {rows[name]:>12,d}")
    lines.append(f"{'TOTAL':<{width}s}  {total:>12,d}")
    return "\n".join(lines)
