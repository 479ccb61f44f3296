"""Parity of the registry's DenseNet, MobileNetV2, MNASNet, ShuffleNetV2, RegNetX/Y
and CLIP (ViT-B/32, RN50) families with the JAX package's, on the CPU: the
four feature stages.

Each module's four feature stages against the JAX module on the same seeded
variables (`test_torch_feature_registry.seed_tree`, carried into the port
by `load_jax_variables`) and the same input: one name per module at 32²
(DenseNet at 64², whose last stage is /64) and batch 2, one RegNetX and one
RegNetY (squeeze-excite), CLIP ViT-B/32 at 224² and batch 1. Tolerance:
each stage within `STAGE_TOL` = 1e-5 of its max |ref| (fp32 sum order).
The trees of all 25 names are in `test_torch_feature_registry_trees.py`,
the converters and layouts in `test_torch_feature_registry_convert.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.backbones import registry as jreg
from stylegan3_editing_tpu_torch.models.backbones import registry as preg
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from test_torch_feature_registry import seed_tree

torch.set_num_threads(1)

STAGE_TOL = 1e-5
FAMILIES = {  # name: (input side, batch)
    "densenet121": (64, 2),
    "mobilenet_v2": (32, 2),
    "mnasnet1_0": (32, 2),
    "shufflenet_v2_x0_5": (32, 2),
    "regnetx_002": (32, 2),
    "regnety_002": (32, 2),
    "resnet50_clip": (32, 2),
    "clip_vit_b32": (224, 1),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_stages_match_jax(name):
    side, batch = FAMILIES[name]
    x = np.random.RandomState(0).randn(batch, side, side, 3).astype(np.float32)
    jmod, _ = jreg.make_feature_network(name)
    variables = seed_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                          seed=len(name))
    want = jax.jit(jmod.apply)(variables, x)
    port, spec = preg.make_feature_network(name, generator=torch.Generator().manual_seed(0))
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and w.shape[-1] == spec.channels[i], (i, g.shape)
        err, scale = float(np.abs(g.numpy() - w).max()), float(np.abs(w).max())
        print(f"{name} stage {i} {w.shape}: max abs err {err:.3g}, max |ref| {scale:.3g}")
        assert scale > 0 and err <= STAGE_TOL * scale, (name, i)
