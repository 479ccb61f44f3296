"""The port's ReStyle encoders on IR-SE-50 at its full depth against the JAX
package's, on the CPU.

pSp and e4e share one tree: `encoder_variables` of `test_torch_encoders.py`
(`jax.eval_shape` of the flax init, every leaf from a numpy seed, batch-norm
statistics non-trivial), copied into the port by `load_jax_variables`. One
seeded 256² batch of one 6-channel image goes through both, the JAX side
jitted. Codes are held at 1e-4 of max |ref|: IR-SE-50's 24 bottlenecks (53
convs, 49 batch norms) and a head of 4 convs, fp32 on both sides, summing
in another order in XLA and in PyTorch (about 1e-7 relative a sum).
"""

import jax
import pytest
import torch

from stylegan3_editing_tpu.models.encoders import backbones as jbackbones
from stylegan3_editing_tpu_torch.models.encoders import (BackboneEncoder,
                                                         ProgressiveBackboneEncoder)
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from test_torch_encoders import ENCODER_TOL, check, encoder_variables, seeded, t

torch.set_num_threads(1)

N_STYLES = 3


@pytest.mark.parametrize("name", ["BackboneEncoder", "ProgressiveBackboneEncoder"])
def test_irse50_encoder_matches_jax(name):
    jcls, tcls = {"BackboneEncoder": (jbackbones.BackboneEncoder, BackboneEncoder),
                  "ProgressiveBackboneEncoder": (jbackbones.ProgressiveBackboneEncoder,
                                                 ProgressiveBackboneEncoder)}[name]
    v = encoder_variables(50, N_STYLES, seed=80)
    x = seeded(1, 256, 256, 6, seed=81)
    ref = jax.jit(jcls(num_layers=50, n_styles=N_STYLES).apply)(v, x)
    m = tcls(num_layers=50, n_styles=N_STYLES, input_nc=6)
    load_jax_variables(m, v)
    assert m.trunk.n_blocks == 24
    with torch.no_grad():
        got = m(t(x))
    check(got, ref, ENCODER_TOL, f"{name} IR-SE-50")
