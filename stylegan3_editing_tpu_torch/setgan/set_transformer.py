"""Set transformer blocks, mask-aware.

Counterpart of the JAX package's `setgan/set_transformer.py` (reference
models/setgan/set.py): `MHA` with logits scaled by √dim_v (the reference's
latent size, not the head width) and an optional learned temperature,
`SetAttentionBlock`, `SetEncoderBlock` / `SetDecoderBlock`,
`SetTransformerEncoder` / `Decoder`, `MultiSetAttentionBlock` /
`MultiSetTransformerEncoder` and `PMA` pooling. Sets of variable size are
padded to a fixed size and masked: a masked key gets −1e9 before the
softmax, and a query row with no valid key attends to nothing (zeros, not
NaN). LayerNorm ε is 1e-5 and the leaky ReLU's slope 0.01. Attention is
plain products and a softmax, every matmul in full fp32
(`device.fp32_matmul`). Parameters carry the flax names and layouts
(``attn1.w_q.kernel`` ``[in, out]``), so `models.sg3.load_jax_variables`
fills them from the JAX package's variables. Dropout acts only with
``train=True``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import fp32_matmul
from ..models.backbones.common import Dense, LayerNorm

LN_EPS = 1e-5
LRELU_SLOPE = 0.01


def _activation(name: str):
    return F.relu if name == "relu" else (lambda x: F.leaky_relu(x, LRELU_SLOPE))


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` with masked (False) entries at −1e9; rows with no
    valid entry give zeros."""
    if mask is None:
        return logits.softmax(dim)
    # Python scalars, not new tensors: a tensor made from a host value is a
    # copy to the card, which waits for the work queued before it.
    probs = torch.where(mask, logits, -1e9).softmax(dim)
    return torch.where(mask.any(dim, keepdim=True), probs, 0.0)


class MHA(nn.Module):
    """Multi-head attention over sets: Q ``[N, Tq, Dq]`` attends K ``[N, Tk, Dk]``;
    ``mask`` ``[N, Tq, Tk]`` or ``[N, 1, Tk]`` (True = a valid key)."""

    def __init__(self, q_size: int, k_size: int, dim_v: int, num_heads: int,
                 use_temperature: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim_v, self.num_heads = dim_v, num_heads
        self.w_q = Dense(q_size, dim_v, generator)
        self.w_k = Dense(k_size, dim_v, generator)
        self.w_v = Dense(k_size, dim_v, generator)
        self.w_o = Dense(dim_v, dim_v, generator)
        self.temperature = nn.Parameter(torch.ones(())) if use_temperature else None

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, tq, dv, h = q.shape[0], q.shape[1], self.dim_v, self.num_heads
        with fp32_matmul():
            def split(a):
                return a.reshape(a.shape[0], a.shape[1], h, dv // h).transpose(1, 2)

            q_, k_, v_ = split(self.w_q(q)), split(self.w_k(k)), split(self.w_v(k))
            logits = q_ @ k_.transpose(-1, -2) / math.sqrt(dv)
            if self.temperature is not None:
                logits = logits * self.temperature
            if mask is not None and mask.ndim == 3:
                mask = mask[:, None]  # over the heads
            attn = masked_softmax(logits, mask)
            return self.w_o((attn @ v_).transpose(1, 2).reshape(n, tq, dv))


class SetAttentionBlock(nn.Module):
    """q + MHA(q, k) → [LN] → + MLP → [LN], dropout after the attention and
    the MLP."""

    def __init__(self, latent_size: int, hidden_size: int, num_heads: int, ln: bool = True,
                 dropout: float = 0.1, activation: str = "relu", k_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout, self.act = dropout, _activation(activation)
        self.attn = MHA(latent_size, k_size or latent_size, latent_size, num_heads,
                        generator=generator)
        self.fc1 = Dense(latent_size, hidden_size, generator=generator)
        self.fc2 = Dense(hidden_size, latent_size, generator=generator)
        if ln:
            self.ln0, self.ln1 = LayerNorm(latent_size, LN_EPS), LayerNorm(latent_size, LN_EPS)
        self.ln = ln

    def forward(self, q, k, mask=None, train: bool = False):
        x = q + F.dropout(self.attn(q, k, mask=mask), self.dropout, train)
        if self.ln:
            x = self.ln0(x)
        with fp32_matmul():
            f = self.fc2(self.act(self.fc1(x)))
        x = x + F.dropout(f, self.dropout, train)
        return self.ln1(x) if self.ln else x


class SetEncoderBlock(nn.Module):
    """Self-attention over one set (`SetAttentionBlock` of x on x)."""

    def __init__(self, latent_size: int, hidden_size: int, num_heads: int, ln: bool = False,
                 dropout: float = 0.1, activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attn = SetAttentionBlock(latent_size, hidden_size, num_heads, ln, dropout,
                                      activation, generator=generator)

    def forward(self, x, mask=None, train: bool = False):
        return self.attn(x, x, mask=mask, train=train)


class SetDecoderBlock(nn.Module):
    """[self-attention of q] → cross-attention to k → MLP, each residual
    with dropout and, with ``ln``, a LayerNorm."""

    def __init__(self, latent_size: int, hidden_size: int, num_heads: int, ln: bool = False,
                 dropout: float = 0.1, activation: str = "relu", self_attn: bool = True,
                 use_temperature: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout, self.act, self.ln, self.self_attn = (dropout, _activation(activation),
                                                           ln, self_attn)
        if self_attn:
            self.attn1 = MHA(latent_size, latent_size, latent_size, num_heads,
                             use_temperature=use_temperature, generator=generator)
        self.attn2 = MHA(latent_size, latent_size, latent_size, num_heads,
                         use_temperature=use_temperature, generator=generator)
        self.fc1 = Dense(latent_size, hidden_size, generator=generator)
        self.fc2 = Dense(hidden_size, latent_size, generator=generator)
        if ln:
            if self_attn:
                self.ln0 = LayerNorm(latent_size, LN_EPS)
            self.ln1, self.ln2 = LayerNorm(latent_size, LN_EPS), LayerNorm(latent_size, LN_EPS)

    def forward(self, q, k, mask=None, self_mask=None, train: bool = False):
        x = q
        if self.self_attn:
            x = q + F.dropout(self.attn1(q, q, mask=self_mask), self.dropout, train)
            if self.ln:
                x = self.ln0(x)
        x = x + F.dropout(self.attn2(x, k, mask=mask), self.dropout, train)
        if self.ln:
            x = self.ln1(x)
        with fp32_matmul():
            f = self.fc2(self.act(self.fc1(x)))
        x = x + F.dropout(f, self.dropout, train)
        return self.ln2(x) if self.ln else x


class SetTransformerEncoder(nn.Module):
    def __init__(self, input_size: int, latent_size: int, hidden_size: int, num_heads: int,
                 num_blocks: int, ln: bool = False, dropout: float = 0.1,
                 activation: str = "relu", generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_size != latent_size:
            self.proj = Dense(input_size, latent_size, generator=generator)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", SetEncoderBlock(latent_size, hidden_size, num_heads,
                                                          ln, dropout, activation, generator))

    def forward(self, x, mask=None, train: bool = False):
        if hasattr(self, "proj"):
            with fp32_matmul():
                x = self.proj(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, mask=mask, train=train)
        return x


class SetTransformerDecoder(nn.Module):
    def __init__(self, input_size: int, latent_size: int, hidden_size: int, num_heads: int,
                 num_blocks: int, ln: bool = False, dropout: float = 0.1,
                 activation: str = "relu", self_attn: bool = True,
                 use_temperature: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_size != latent_size:
            self.proj = Dense(input_size, latent_size, generator=generator)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", SetDecoderBlock(
                latent_size, hidden_size, num_heads, ln, dropout, activation, self_attn,
                use_temperature, generator))

    def forward(self, q, encoder_outputs, mask=None, train: bool = False):
        if hasattr(self, "proj"):
            with fp32_matmul():
                q = self.proj(q)
        for i in range(self.num_blocks):
            q = getattr(self, f"block_{i}")(q, encoder_outputs, mask=mask, train=train)
        return q


class MultiSetAttentionBlock(nn.Module):
    """Self and cross attention over two sets, merged by concat → Dense:
    x + fc_X([xx ‖ xy]), y + fc_Y([yy ‖ yx]). ``weight_sharing``: 'none',
    'cross' (one block for xy and yx) or 'sym' (one for the self pair too)."""

    def __init__(self, latent_size: int, hidden_size: int, num_heads: int,
                 weight_sharing: str = "none", ln: bool = False, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def block():
            return SetAttentionBlock(latent_size, hidden_size, num_heads, ln=ln,
                                     dropout=dropout, generator=generator)

        names = {"none": ("MAB_XX", "MAB_YY", "MAB_XY", "MAB_YX"),
                 "cross": ("MAB_XX", "MAB_YY", "MAB_cross", "MAB_cross"),
                 "sym": ("MAB_self", "MAB_self", "MAB_cross", "MAB_cross")}
        if weight_sharing not in names:
            raise NotImplementedError(weight_sharing)
        self.roles = names[weight_sharing]  # xx, yy, xy, yx
        for name in dict.fromkeys(self.roles):
            self.add_module(name, block())
        self.fc_X = Dense(2 * latent_size, latent_size, generator=generator)
        self.fc_Y = Dense(2 * latent_size, latent_size, generator=generator)
        self.dropout, self.ln = dropout, ln
        if ln:
            self.ln_x, self.ln_y = LayerNorm(latent_size, LN_EPS), LayerNorm(latent_size, LN_EPS)

    def forward(self, x, y, masks: Optional[Tuple] = None, train: bool = False):
        mab_xx, mab_yy, mab_xy, mab_yx = (getattr(self, n) for n in self.roles)
        m_xx, m_xy, m_yx, m_yy = masks if masks is not None else (None,) * 4
        xx = mab_xx(x, x, mask=m_xx, train=train)
        xy = mab_xy(x, y, mask=m_xy, train=train)
        yx = mab_yx(y, x, mask=m_yx, train=train)
        yy = mab_yy(y, y, mask=m_yy, train=train)
        with fp32_matmul():
            x_m = self.fc_X(torch.cat([xx, xy], dim=-1))
            y_m = self.fc_Y(torch.cat([yy, yx], dim=-1))
        x_out = x + F.dropout(x_m, self.dropout, train)
        y_out = y + F.dropout(y_m, self.dropout, train)
        if self.ln:
            x_out, y_out = self.ln_x(x_out), self.ln_y(y_out)
        return x_out, y_out


class MultiSetTransformerEncoder(nn.Module):
    def __init__(self, x_size: int, y_size: int, latent_size: int, hidden_size: int,
                 num_heads: int, num_blocks: int, weight_sharing: str = "none",
                 ln: bool = False, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if x_size != latent_size:
            self.proj_x = Dense(x_size, latent_size, generator=generator)
        if y_size != latent_size:
            self.proj_y = Dense(y_size, latent_size, generator=generator)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", MultiSetAttentionBlock(
                latent_size, hidden_size, num_heads, weight_sharing, ln, dropout, generator))

    def forward(self, x, y, masks=None, train: bool = False):
        with fp32_matmul():
            if hasattr(self, "proj_x"):
                x = self.proj_x(x)
            if hasattr(self, "proj_y"):
                y = self.proj_y(y)
        for i in range(self.num_blocks):
            x, y = getattr(self, f"block_{i}")(x, y, masks=masks, train=train)
        return x, y


class PMA(nn.Module):
    """Pooling by multihead attention: ``num_seeds`` learned seeds ``S``
    (Xavier uniform) attend the set."""

    def __init__(self, latent_size: int, hidden_size: int, num_heads: int, num_seeds: int = 1,
                 ln: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = math.sqrt(6 / (num_seeds + latent_size))
        self.S = nn.Parameter((torch.rand((1, num_seeds, latent_size), generator=generator)
                               * 2 - 1) * bound)
        self.mab = SetAttentionBlock(latent_size, hidden_size, num_heads, ln=ln,
                                     generator=generator)

    def forward(self, x, mask=None, train: bool = False):
        s = self.S.expand((x.shape[0],) + tuple(self.S.shape[1:]))
        return self.mab(s, x, mask=mask, train=train)
