"""Path registry of the released weights the port reads.

A slice of the JAX package's `configs.py`: the entries a ported module uses.

Parity: reference configs/paths_config.py. Paths are overridable through
SG3TPU_MODELS so the framework runs anywhere without editing source.
"""

from __future__ import annotations

import os
from pathlib import Path

_MODELS = Path(os.environ.get("SG3TPU_MODELS", "/pretrained_models"))

model_paths = {
    # Editing assets.
    "interfacegan_boundaries": _MODELS / "interfacegan",
}
