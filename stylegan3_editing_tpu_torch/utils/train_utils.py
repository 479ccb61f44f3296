"""Training helpers: loss-dict aggregation and face-grid visualisation.

Counterpart of the JAX package's `utils/train_utils.py` (reference
utils/train_utils.py: `aggregate_loss_dict` :7 and `vis_faces` :20-43,
here PIL grids instead of matplotlib). PIL is imported inside `vis_faces`
only (the card machine has none).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .common import tensor2im


def aggregate_loss_dict(agg_loss_dict: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """List of per-batch loss dicts → mean per key."""
    mean_vals: Dict[str, List[float]] = {}
    for output in agg_loss_dict:
        for key, value in output.items():
            mean_vals.setdefault(key, []).append(float(value))
    return {key: (sum(vals) / len(vals)) if vals else 0.0 for key, vals in mean_vals.items()}


def vis_faces(im_data: Sequence[dict], cell: int = 256):
    """Rows of (input, target, output[s]) faces with optional captions, as
    one PIL image.

    Each entry: ``{'input_face': PIL/array/tensor, 'target_face': ...,
    'output_face': PIL/array/tensor or a list of (image, caption)}`` (+ extra
    scalar annotations, written over the row's first cell).
    """
    from PIL import Image, ImageDraw

    def to_pil(v):
        if isinstance(v, Image.Image):
            return v.resize((cell, cell))
        return tensor2im(v).resize((cell, cell))

    rows = []
    for entry in im_data:
        cells = [to_pil(entry["input_face"]), to_pil(entry["target_face"])]
        out = entry["output_face"]
        if isinstance(out, list):
            for item in out:
                cells.append(to_pil(item[0] if isinstance(item, (tuple, list)) else item))
        else:
            cells.append(to_pil(out))
        rows.append(cells)

    n_cols = max(len(r) for r in rows)
    canvas = Image.new("RGB", (n_cols * cell, len(rows) * cell), "white")
    for i, row in enumerate(rows):
        for j, img in enumerate(row):
            canvas.paste(img, (j * cell, i * cell))
    draw = ImageDraw.Draw(canvas)
    for i, entry in enumerate(im_data):
        extras = {k: v for k, v in entry.items()
                  if k not in ("input_face", "target_face", "output_face")}
        if extras:
            text = ", ".join(f"{k}={float(np.ravel(np.asarray(v))[0]):.2f}"
                             for k, v in extras.items())
            draw.text((4, i * cell + 4), text, fill="red")
    return canvas
