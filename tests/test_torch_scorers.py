"""Parity of the port's image ops, VGG16, ResNet-50 and attribute scorers with
the JAX package's, on the CPU.

Weights: each JAX tree is shaped by `jax.eval_shape` of the flax init and
filled from a numpy seed (`test_torch_encoders.seeded_variables`: kernels
normal with std 1/sqrt(fan in), batch-norm statistics and affines
non-trivial), then copied into the port by `load_jax_variables`. Inputs are
seeded numpy arrays.

Tolerances:
- the resizes and pools: 1e-5 of max |ref| (one bilinear weight sum or one
  window sum in another order); the nearest resize and max pool exactly;
- VGG16, ResNet-50, a bottleneck and the three scorers: 1e-4 of max |ref|
  (fp32 convs summing in another order in XLA and in PyTorch, 13 and 53
  convs deep);
- `score_latents`: exactly the scorer's output, batch by batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.editing import attribute_scorers as jscorers
from stylegan3_editing_tpu.models.backbones import resnet as jresnet
from stylegan3_editing_tpu.models.backbones import vgg as jvgg
from stylegan3_editing_tpu.ops import image as jimage
from stylegan3_editing_tpu_torch.editing import attribute_scorers as scorers
from stylegan3_editing_tpu_torch.models.backbones import resnet, vgg
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from stylegan3_editing_tpu_torch.ops import image
from test_torch_encoders import check, init_module, seeded, t

torch.set_num_threads(1)

OP_TOL = 1e-5
NET_TOL = 1e-4


# ------------------------------------------------------------------ image ops

@pytest.mark.parametrize("src,size", [(32, 224), (20, (33, 47)), (100, 37)],
                         ids=["x7", "ragged-up", "down"])
def test_resize_nearest_matches_jax(src, size):
    x = seeded(2, src, src + 3, 3, seed=1)
    got = image.resize_nearest(t(x), size)
    ref = jimage.resize_nearest(jnp.asarray(x), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("src", [1024, 32], ids=["1024-to-224", "32-to-224"])
def test_resize_bilinear_matches_jax(src):
    """`jax.image.resize(..., "linear", antialias=False)` is PyTorch's
    bilinear `F.interpolate` with ``align_corners=False``, shrinking and
    growing (the edge samples' weights outside the image fall to the edge)."""
    x = seeded(1, src, src, 3, seed=2)
    check(image.resize_bilinear(t(x), 224), jimage.resize_bilinear(jnp.asarray(x), 224),
          OP_TOL, f"resize_bilinear {src}->224")


@pytest.mark.parametrize("window,stride", [(7, None), (2, 1), (32, None)])
def test_avg_pool2d_matches_jax(window, stride):
    x = seeded(2, 64, 70, 3, seed=3)
    check(image.avg_pool2d(t(x), window, stride),
          jimage.avg_pool2d(jnp.asarray(x), window, stride), OP_TOL,
          f"avg_pool2d {window}/{stride}")


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (2, 2, 0), (3, 2, 0)])
def test_max_pool2d_padding_matches_jax(window, stride, padding):
    x = seeded(2, 22, 23, 4, seed=4)
    got = image.max_pool2d(t(x), window, stride, padding=padding)
    ref = jimage.max_pool2d(jnp.asarray(x), window, stride, padding=padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------------ backbones

def test_vgg16_features_match_jax():
    x = seeded(2, 32, 40, 3, seed=5)
    v = init_module(jvgg.VGG16Features(), x, seed=6)
    m = vgg.VGG16Features()
    load_jax_variables(m, v)
    ref = jax.jit(jvgg.VGG16Features().apply)(v, x)
    with torch.no_grad():
        got = m(t(x))
    assert len(got) == len(ref) == 5
    for i, (a, b) in enumerate(zip(got, ref)):
        check(a, b, NET_TOL, f"VGG16 stage {i + 1}")


def test_vgg19_has_the_jax_tree():
    shapes = jax.eval_shape(jvgg.VGG19Features().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    flat = {".".join(p.key for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert flat == {k: tuple(v.shape) for k, v in vgg.VGG19Features().state_dict().items()}


@pytest.mark.parametrize("in_c,width,out_c,stride,down", [(64, 64, 256, 1, True),
                                                          (256, 128, 512, 2, True),
                                                          (512, 128, 512, 1, False)],
                         ids=["first", "strided", "identity"])
def test_bottleneck_matches_jax(in_c, width, out_c, stride, down):
    x = seeded(2, 9, 10, in_c, seed=7)
    jb = jresnet.Bottleneck(width, out_c, stride=stride, downsample=down)
    v = init_module(jb, x, seed=8)
    m = resnet.Bottleneck(in_c, width, out_c, stride, down)
    load_jax_variables(m, v)
    with torch.no_grad():
        check(m(t(x)), jb.apply(v, x), NET_TOL, "Bottleneck")


def test_resnet50_features_match_jax():
    x = seeded(2, 64, 64, 3, seed=9)
    v = init_module(jresnet.ResNet50Features(), x, seed=10)
    m = resnet.ResNet50Features()
    load_jax_variables(m, v)
    with torch.no_grad():
        check(m(t(x)), jax.jit(jresnet.ResNet50Features().apply)(v, x), NET_TOL,
              "ResNet50Features")


# ------------------------------------------------------------------- scorers

def _scorer_pair(jcls, tcls, seed):
    x0 = np.zeros((1, 224, 224, 3), np.float32)
    v = init_module(jcls(), x0, seed=seed)
    m = tcls(device="cpu")
    load_jax_variables(m, v)
    return jax.jit(jcls().apply), v, m


def test_age_estimator_matches_jax():
    x = seeded(2, 48, 48, 3, seed=11)
    apply, v, m = _scorer_pair(jscorers.AgeEstimator, scorers.AgeEstimator, 12)
    with torch.no_grad():
        check(m(t(x)), apply(v, x), NET_TOL, "AgeEstimator")


def test_age_estimator_reads_the_top_left_7x7_of_relu5_3(monkeypatch):
    """As in the JAX package (`editing/attribute_scorers.py:48`), the DEX head
    reads the top-left 7×7 of VGG16's 14×14 relu5_3 map, not a fifth pool:
    the rest of the map does not move the age."""
    m = scorers.AgeEstimator(device="cpu")
    feats = torch.from_numpy(np.abs(seeded(1, 14, 14, 512, seed=13)))
    monkeypatch.setattr(m.vgg, "forward", lambda x: [feats])
    with torch.no_grad():
        before = m(torch.zeros((1, 8, 8, 3)))
        feats[:, 7:, :, :] += 5
        feats[:, :, 7:, :] += 5
        same = m(torch.zeros((1, 8, 8, 3)))
        feats[:, :7, :7, :] += 5
        moved = m(torch.zeros((1, 8, 8, 3)))
    assert float(same) == float(before) != float(moved)


def test_pose_estimator_matches_jax():
    x = seeded(2, 40, 40, 3, seed=14)
    apply, v, m = _scorer_pair(jscorers.PoseEstimator, scorers.PoseEstimator, 15)
    ref = apply(v, x)
    with torch.no_grad():
        got = m(t(x))
    assert set(got) == set(ref) == {"yaw", "pitch", "roll"}
    for k in got:
        check(got[k], ref[k], NET_TOL, f"PoseEstimator {k}")


def test_attribute_classifier_matches_jax():
    x = seeded(2, 40, 40, 3, seed=16)
    apply, v, m = _scorer_pair(jscorers.AttributeClassifier, scorers.AttributeClassifier, 17)
    with torch.no_grad():
        got = m(t(x))
    assert got.shape == (2, len(scorers.CELEBA_ATTRIBUTES))
    check(got, apply(v, x), NET_TOL, "AttributeClassifier")
    assert scorers.CELEBA_ATTRIBUTES == jscorers.CELEBA_ATTRIBUTES


def test_score_latents_matches_jax():
    """Batches of ``batch_size`` (the last one short), one score per latent,
    as ``[N, 1]``, from the same generator and scorer functions."""
    ws = seeded(11, 3, 8, seed=18)
    w = seeded(24, 12, seed=19)

    def jgen(chunk, transform):
        assert transform is None
        return jnp.tanh(chunk.reshape(chunk.shape[0], -1) @ w).reshape(-1, 2, 2, 3)

    def tgen(chunk, transform):
        assert transform is None
        return torch.tanh(chunk.reshape(chunk.shape[0], -1) @ t(w)).reshape(-1, 2, 2, 3)

    sizes = []
    got = scorers.score_latents(tgen, lambda im: sizes.append(len(im)) or im.sum((1, 2, 3)),
                                t(ws), batch_size=4)
    ref = jscorers.score_latents(jgen, lambda im: im.sum((1, 2, 3)), jnp.asarray(ws),
                                 batch_size=4)
    assert sizes == [4, 4, 3] and got.shape == ref.shape == (11, 1)
    check(got, ref, OP_TOL, "score_latents")
