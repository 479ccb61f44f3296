"""RestyleNet with each ResNet-34 trunk against the JAX package's, on the CPU.

On the 64² SG3 decoder of `test_torch_encoders.py`'s `TINY`, with the
seeded trees of `test_torch_resnet_encoders.py`: the average image and two
iterations with a landmarks transform (every decode the dual one). The
images at 2e-4 absolute (the generator tests' 1e-4 on top of the codes' own
error), the codes at 1e-4 of max |ref| (fp32 on both sides; the convs sum
in another order in XLA and in PyTorch).
"""

import jax
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.models.encoders import restyle as jrestyle
from stylegan3_editing_tpu.models.sg3 import SG3Config as JSG3Config
from stylegan3_editing_tpu_torch.models.encoders import (RestyleNet, get_average_image,
                                                         run_restyle_iterations)
from stylegan3_editing_tpu_torch.models.sg3 import SG3Config, load_jax_variables
from test_torch_encoders import (ENCODER_TOL, IMAGE_ATOL, TINY, check, generator_variables,
                                 seeded, t)
from test_torch_resnet_encoders import ENCODERS, resnet_encoder_variables

torch.set_num_threads(1)


@pytest.mark.parametrize("encoder_type", sorted(ENCODERS))
def test_resnet_restyle_matches_jax(encoder_type):
    """RestyleNet with each ResNet trunk on the 64² decoder: the average
    image and two iterations with a landmarks transform (every decode the
    dual one), the JAX package's in one `jax.jit`."""
    n_styles = SG3Config(**TINY).num_ws
    ev = resnet_encoder_variables(n_styles, seed=77)
    gv = generator_variables(JSG3Config(**TINY), seed=78)
    v = {"params": {"encoder": ev["params"], "decoder": gv["params"]},
         "batch_stats": {"encoder": ev["batch_stats"]},
         "buffers": {"decoder": gv["buffers"]}, "ema": {"decoder": gv["ema"]}}
    jmodel = jrestyle.RestyleNet(decoder_cfg=JSG3Config(**TINY), encoder_type=encoder_type,
                                 n_styles=n_styles)
    tmodel = RestyleNet(SG3Config(**TINY), encoder_type, n_styles=n_styles, device="cpu")
    load_jax_variables(tmodel, v)
    assert tmodel.is_progressive == ("Progressive" in encoder_type)
    x = seeded(1, 256, 256, 3, seed=79)
    lt = np.eye(3, dtype=np.float32)
    lt[0, 2] = 0.06

    def jax_run(v, x, lt):
        avg, lat = jrestyle.get_average_image(jmodel, v)
        return avg, jrestyle.run_restyle_iterations(jmodel, v, x, avg, lat, n_iters=2,
                                                    landmarks_transform=lt)

    javg, ref = jax.jit(jax_run)(v, x, lt)
    with torch.no_grad():
        avg, lat = get_average_image(tmodel)
        got = run_restyle_iterations(tmodel, t(x), avg, lat, n_iters=2,
                                     landmarks_transform=t(lt))
    check(avg, javg, IMAGE_ATOL, "average image", absolute=True)
    for step, ((a, u, c), (ra, ru, rc)) in enumerate(zip(got, ref)):
        check(c, rc, ENCODER_TOL, f"iteration {step} codes")
        check(a, ra, IMAGE_ATOL, f"iteration {step} aligned image", absolute=True)
        check(u, ru, IMAGE_ATOL, f"iteration {step} unaligned image", absolute=True)
    assert not np.allclose(got[0][2].numpy(), got[1][2].numpy())

