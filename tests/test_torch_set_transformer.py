"""Parity of the port's set transformer with the JAX package's, on the CPU.

Every block gets one tree: shaped by `jax.eval_shape` of the flax init and
filled from a numpy seed (`seeded_tree`: dense kernels normal with std
1/sqrt(fan in), biases and LayerNorm affines non-trivial, a temperature
near 1, PMA's seeds normal), copied into the port by `load_jax_variables`.
Dropout is compared in eval mode (``train=False``): torch's dropout stream
cannot match flax's.

Tolerance: 1e-5 of max |ref| for every block (fp32 products of width ≤ 64,
summed in another order by XLA and by PyTorch, at most four blocks deep).
Padded slots are held to the same tolerance against the unpadded set, and
a query with no valid key must give exact zeros.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.setgan import set_transformer as jst
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables
from stylegan3_editing_tpu_torch.setgan import set_transformer as st

torch.set_num_threads(1)

TOL = 1e-5
D, H, HEADS = 16, 32, 4


def seeded_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        last = path[-1].key
        z = rng.standard_normal(leaf.shape, dtype=np.float32)
        if last == "kernel":
            v = z / math.sqrt(leaf.shape[0])
        elif last == "scale":
            v = 1 + 0.1 * z
        elif last == "temperature":
            v = 1 + 0.2 * z
        elif last in ("bias", "S"):
            v = 0.1 * z if last == "bias" else z
        else:
            raise KeyError(last)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def pair(jmod, tmod, *args, seed=0, **kwargs):
    """(JAX variables, the port module filled with them)."""
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kwargs),
                            *jax.tree_util.tree_map(jnp.asarray, args))
    variables = seeded_tree(shapes, seed)
    load_jax_variables(tmod, variables)
    return variables, tmod.eval()


def close(got, ref, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max(), err_msg=what)


def rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def key_mask(n, tq, valid, per_query=True):
    """``[n, tq, tk]`` (or ``[n, 1, tk]``) with the first ``valid[i]`` keys of row i."""
    tk = max(valid) + 2
    m = np.zeros((n, 1, tk), bool)
    for i, v in enumerate(valid):
        m[i, :, :v] = True
    return np.repeat(m, tq, axis=1) if per_query else m


# --------------------------------------------------------------- masked softmax

def test_masked_softmax_matches_jax_and_zero_rows():
    logits = rnd(2, 3, 4, 6)
    mask = np.ones((2, 3, 4, 6), bool)
    mask[0, :, :, 4:] = False
    mask[1, 1, 2] = False  # a row with no valid key
    want = np.asarray(jst.masked_softmax(jnp.asarray(logits), jnp.asarray(mask)))
    got = st.masked_softmax(_t(logits), _t(mask))
    close(got, want)
    assert torch.all(got[1, 1, 2] == 0) and torch.all(got[0, ..., 4:] == 0)
    close(st.masked_softmax(_t(logits), None), jax.nn.softmax(jnp.asarray(logits), -1))


# ------------------------------------------------------------------------ MHA

@pytest.mark.parametrize("use_temperature", [False, True])
@pytest.mark.parametrize("mask_kind", [None, "per_query", "broadcast"])
def test_mha_matches_jax(use_temperature, mask_kind):
    q, k = rnd(3, 5, D, seed=1), rnd(3, 7, D, seed=2)
    mask = None if mask_kind is None else key_mask(3, 5, (5, 2, 3), mask_kind == "per_query")
    k = k if mask is None else rnd(3, mask.shape[-1], D, seed=2)
    jm = jst.MHA(D, HEADS, use_temperature=use_temperature)
    v, tm = pair(jm, st.MHA(D, D, D, HEADS, use_temperature), q, k, mask)
    want = jm.apply(v, jnp.asarray(q), jnp.asarray(k),
                    mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out = tm(_t(q), _t(k), mask=_t(mask))
    close(out, want, "out")


def test_mha_scales_logits_by_sqrt_dim_v():
    """The logits divide by √dim_v (16 → 4), not by √(dim_v / heads) (→ 2):
    with identity projections and zero biases, each head's output is the
    softmax of q·k / 4 times k."""
    tm = st.MHA(D, D, D, HEADS)
    with torch.no_grad():
        for name in ("w_q", "w_k", "w_v", "w_o"):
            getattr(tm, name).kernel.copy_(torch.eye(D))
            getattr(tm, name).bias.zero_()
    q, k = _t(rnd(1, 2, D, seed=3)), _t(rnd(1, 3, D, seed=4))
    with torch.no_grad():
        out = tm(q, k)
    qh, kh = q.reshape(1, 2, HEADS, 4).transpose(1, 2), k.reshape(1, 3, HEADS, 4).transpose(1, 2)
    want = ((qh @ kh.transpose(-1, -2) / 4).softmax(-1) @ kh).transpose(1, 2).reshape(1, 2, D)
    torch.testing.assert_close(out, want)
    wrong = ((qh @ kh.transpose(-1, -2) / 2).softmax(-1) @ kh).transpose(1, 2).reshape(1, 2, D)
    assert not torch.allclose(out, wrong)


# --------------------------------------------------------------------- blocks

@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("activation", ["relu", "lrelu"])
def test_set_attention_and_encoder_blocks_match_jax(ln, activation):
    q, k = rnd(2, 4, D, seed=5), rnd(2, 6, D, seed=6)
    mask = key_mask(2, 4, (4, 2))[:, :, :6]
    jm = jst.SetAttentionBlock(D, H, HEADS, ln=ln, activation=activation)
    v, tm = pair(jm, st.SetAttentionBlock(D, H, HEADS, ln=ln, activation=activation), q, k,
                 mask)
    with torch.no_grad():
        close(tm(_t(q), _t(k), mask=_t(mask)), jm.apply(v, q, k, mask=mask), "SAB")
    x = rnd(2, 6, D, seed=7)
    jm = jst.SetEncoderBlock(D, H, HEADS, ln=ln, activation=activation)
    v, tm = pair(jm, st.SetEncoderBlock(D, H, HEADS, ln=ln, activation=activation), x)
    with torch.no_grad():
        close(tm(_t(x)), jm.apply(v, x), "SetEncoderBlock")


@pytest.mark.parametrize("self_attn", [False, True])
@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("use_temperature", [False, True])
def test_set_decoder_block_matches_jax(self_attn, ln, use_temperature):
    q, k = rnd(2, 3, D, seed=8), rnd(2, 5, D, seed=9)
    mask = key_mask(2, 3, (3, 1))
    self_mask = np.ones((2, 3, 3), bool)
    self_mask[1, :, 2] = False
    kw = dict(ln=ln, activation="lrelu", self_attn=self_attn, use_temperature=use_temperature)
    jm = jst.SetDecoderBlock(D, H, HEADS, **kw)
    v, tm = pair(jm, st.SetDecoderBlock(D, H, HEADS, **kw), q, k, mask, self_mask)
    with torch.no_grad():
        close(tm(_t(q), _t(k), mask=_t(mask), self_mask=_t(self_mask)),
              jm.apply(v, q, k, mask=mask, self_mask=self_mask))


@pytest.mark.parametrize("input_size", [D, 12])
def test_set_transformers_match_jax(input_size):
    x = rnd(2, 6, input_size, seed=10)
    mask = key_mask(2, 6, (4, 6))[:, :, :6]
    jm = jst.SetTransformerEncoder(input_size, D, H, HEADS, 2, ln=True)
    v, tm = pair(jm, st.SetTransformerEncoder(input_size, D, H, HEADS, 2, ln=True), x, mask)
    with torch.no_grad():
        close(tm(_t(x), mask=_t(mask)), jm.apply(v, x, mask=mask), "encoder")
    q, enc = rnd(2, 3, input_size, seed=11), rnd(2, 6, D, seed=12)
    dmask = key_mask(2, 3, (4, 6))[:, :, :6]
    jm = jst.SetTransformerDecoder(input_size, D, H, HEADS, 2, ln=True, activation="lrelu",
                                   use_temperature=True)
    v, tm = pair(jm, st.SetTransformerDecoder(input_size, D, H, HEADS, 2, ln=True,
                                              activation="lrelu", use_temperature=True),
                 q, enc, dmask)
    with torch.no_grad():
        close(tm(_t(q), _t(enc), mask=_t(dmask)), jm.apply(v, q, enc, mask=dmask), "decoder")


@pytest.mark.parametrize("weight_sharing", ["none", "cross", "sym"])
@pytest.mark.parametrize("ln", [False, True])
def test_multiset_blocks_match_jax(weight_sharing, ln):
    x, y = rnd(2, 5, D, seed=13), rnd(2, 3, D, seed=14)
    masks = (key_mask(2, 5, (3, 5))[:, :, :5], key_mask(2, 5, (2, 3))[:, :, :3],
             key_mask(2, 3, (3, 5))[:, :, :5], key_mask(2, 3, (2, 3))[:, :, :3])
    jm = jst.MultiSetAttentionBlock(D, H, HEADS, weight_sharing, ln=ln)
    v, tm = pair(jm, st.MultiSetAttentionBlock(D, H, HEADS, weight_sharing, ln=ln), x, y,
                 masks)
    with torch.no_grad():
        got = tm(_t(x), _t(y), masks=tuple(map(_t, masks)))
    for g, r in zip(got, jm.apply(v, x, y, masks=masks)):
        close(g, r, "MultiSetAttentionBlock")
    jm = jst.MultiSetTransformerEncoder(12, 10, D, H, HEADS, 2, weight_sharing, ln=ln)
    x, y = rnd(2, 5, 12, seed=15), rnd(2, 3, 10, seed=16)
    v, tm = pair(jm, st.MultiSetTransformerEncoder(12, 10, D, H, HEADS, 2, weight_sharing,
                                                   ln=ln), x, y)
    with torch.no_grad():
        got = tm(_t(x), _t(y))
    for g, r in zip(got, jm.apply(v, x, y)):
        close(g, r, "MultiSetTransformerEncoder")


@pytest.mark.parametrize("num_seeds", [1, 3])
def test_pma_matches_jax(num_seeds):
    x = rnd(3, 7, D, seed=17)
    mask = key_mask(3, num_seeds, (7, 2, 4), per_query=False)[:, :, :7]
    jm = jst.PMA(D, H, HEADS, num_seeds=num_seeds, ln=True)
    v, tm = pair(jm, st.PMA(D, H, HEADS, num_seeds=num_seeds, ln=True), x, mask)
    with torch.no_grad():
        close(tm(_t(x), mask=_t(mask)), jm.apply(v, x, mask=mask))


# ---------------------------------------------------------------------- masks

def test_padded_slots_change_nothing():
    """A decoder query and an encoder's valid rows do not move when the
    padded keys hold other values (zeros, then large noise)."""
    enc = st.SetTransformerEncoder(D, D, H, HEADS, 2, ln=True, dropout=0.0,
                                   generator=torch.Generator().manual_seed(0)).eval()
    dec = st.SetTransformerDecoder(D, D, H, HEADS, 2, ln=True, dropout=0.0, activation="lrelu",
                                   generator=torch.Generator().manual_seed(1)).eval()
    valid = _t(rnd(1, 3, D, seed=18))
    a = torch.cat([valid, torch.zeros(1, 2, D)], 1)
    b = torch.cat([valid, 100 * _t(rnd(1, 2, D, seed=19))], 1)
    key = torch.tensor([[True, True, True, False, False]])
    q = _t(rnd(1, 4, D, seed=20))
    with torch.no_grad():
        ea, eb = enc(a, mask=key[:, None].expand(1, 5, 5)), enc(b, mask=key[:, None].expand(1, 5, 5))
        close(ea[:, :3], eb[:, :3].numpy())
        da, db = dec(q, a, mask=key[:, None].expand(1, 4, 5)), dec(q, b, mask=key[:, None])
        close(da, db.numpy())


def test_dropout_follows_train():
    torch.manual_seed(0)
    blk = st.SetAttentionBlock(D, H, HEADS, dropout=0.5,
                               generator=torch.Generator().manual_seed(2))
    x = _t(rnd(2, 4, D, seed=21))
    with torch.no_grad():
        assert torch.equal(blk(x, x), blk(x, x))
        assert not torch.equal(blk(x, x, train=True), blk(x, x))
