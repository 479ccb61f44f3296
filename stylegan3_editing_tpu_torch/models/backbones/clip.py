"""CLIP ViT-B/32 (image and text encoders) in PyTorch, with the OpenAI-weights
converter and the BPE tokenizer.

Counterpart of the JAX package's `models/backbones/clip.py` (the vendored
OpenAI CLIP of the reference: QuickGELU, pre-LN blocks, EOT-token text
pooling, a learned logit scale). Parameters carry the flax names and
layouts (``visual_transformer.resblock_0.attn.in_proj.kernel``, ``[in,
out]`` dense kernels, an HWIO patch kernel), so `models.sg3.load_jax_variables`
fills a `CLIP` from the JAX package's variables or from `convert_clip_state`.
Attention is a plain matmul and softmax, as in the JAX einsums; the patch
conv goes through `device.conv2d` and every matmul runs under
`device.fp32_matmul`, so neither takes TF32 on the card. LayerNorm keeps
flax's epsilon, 1e-6.

`SimpleTokenizer` needs no ``regex`` package: its pattern's Unicode classes
(``\\p{L}``, ``\\p{N}``, ``\\s``) are built from `unicodedata` and the
White_Space list, and the text is scanned by hand with the pattern's
alternatives in their order.
"""

from __future__ import annotations

import gzip
import html
import math
import unicodedata
from functools import lru_cache
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import DeviceLike, fp32_matmul, resolve_device
from .common import Conv2d, Dense, LayerNorm, dense_w, put

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention-compatible MHA, batch first."""

    def __init__(self, width: int, heads: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width, self.heads = width, heads
        self.in_proj = Dense(width, 3 * width, generator=generator)
        self.out_proj = Dense(width, width, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, t, _ = x.shape
        hd = self.width // self.heads
        q, k, v = (a.reshape(n, t, self.heads, hd).transpose(1, 2)
                   for a in self.in_proj(x).chunk(3, dim=-1))
        attn = q @ k.transpose(-1, -2) / np.sqrt(hd)
        if mask is not None:
            attn = attn + mask
        out = attn.softmax(dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(n, t, self.width))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attn = MultiheadAttention(width, heads, generator=generator)
        self.ln_1, self.ln_2 = LayerNorm(width), LayerNorm(width)
        self.c_fc = Dense(width, 4 * width, generator=generator)
        self.c_proj = Dense(4 * width, width, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"resblock_{i}", ResidualAttentionBlock(width, heads, generator))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                hooks: Optional[Sequence[int]] = None):
        """The last block's output; with ``hooks`` (block indices, the
        feature network's taps) also the hooked blocks' outputs in
        ``hooks``' order: ``(x, [x_i for i in hooks])``."""
        hooked = {}
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x, mask)
            if hooks is not None and i in hooks:
                hooked[i] = x
        if hooks is not None:
            return x, [hooked[i] for i in hooks]
        return x


class CLIP(nn.Module):
    """ViT-B/32 CLIP. Images: NHWC at ``image_resolution``², CLIP-normalised
    (`clip_preprocess_from_synth`). Text: token ids ``[N, 77]``.

    Built on the CUDA card unless ``device="cpu"``; weights are random from
    ``generator`` (seed 0 by default) until `load_jax_variables` fills them.
    """

    def __init__(self, embed_dim: int = 512, image_resolution: int = 224,
                 vision_width: int = 768, vision_layers: int = 12, vision_patch: int = 32,
                 text_width: int = 512, text_layers: int = 12, text_heads: int = 8,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.image_resolution, self.vision_width = image_resolution, vision_width
        grid = image_resolution // vision_patch
        scale = vision_width ** -0.5

        def randn(*shape, std=1.0):
            return nn.Parameter(std * torch.randn(shape, generator=generator))

        self.visual_conv1 = Conv2d(3, vision_width, vision_patch, stride=vision_patch,
                                   generator=generator, use_bias=False)
        self.class_embedding = randn(vision_width, std=scale)
        self.visual_positional_embedding = randn(grid * grid + 1, vision_width, std=scale)
        self.ln_pre = LayerNorm(vision_width)
        self.visual_transformer = Transformer(vision_width, vision_layers, vision_width // 64,
                                              generator)
        self.ln_post = LayerNorm(vision_width)
        self.visual_proj = randn(vision_width, embed_dim, std=scale)

        self.token_embedding = nn.Module()
        self.token_embedding.embedding = randn(VOCAB_SIZE, text_width,
                                               std=text_width ** -0.5)
        self.positional_embedding = randn(CONTEXT_LENGTH, text_width, std=0.01)
        self.transformer = Transformer(text_width, text_layers, text_heads, generator)
        self.ln_final = LayerNorm(text_width)
        self.text_projection = randn(text_width, embed_dim, std=text_width ** -0.5)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.to(device)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        with fp32_matmul():
            x = self.visual_conv1(image)  # [N, g, g, W]
            n = x.shape[0]
            x = x.reshape(n, -1, self.vision_width)
            cls = self.class_embedding[None, None].expand(n, 1, self.vision_width)
            x = torch.cat([cls, x], dim=1) + self.visual_positional_embedding[None]
            x = self.visual_transformer(self.ln_pre(x))
            return self.ln_post(x[:, 0, :]) @ self.visual_proj

    def encode_text(self, text) -> torch.Tensor:
        """text: ``[N, 77]`` token ids (0-padded after EOT), numpy or torch."""
        text = torch.as_tensor(text, dtype=torch.long, device=self.positional_embedding.device)
        with fp32_matmul():
            x = self.token_embedding.embedding[text] + self.positional_embedding[None]
            t = text.shape[1]
            causal = torch.full((t, t), -math.inf, device=x.device).triu(1)
            x = self.ln_final(self.transformer(x, causal))
            eot = text.argmax(dim=-1)  # EOT has the highest id; ties pick the first
            return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection

    def forward(self, image: torch.Tensor, text):
        img_f = self.encode_image(image)
        txt_f = self.encode_text(text)
        img_f = img_f / img_f.norm(dim=-1, keepdim=True)
        txt_f = txt_f / txt_f.norm(dim=-1, keepdim=True)
        with fp32_matmul():
            logits_per_image = self.logit_scale.exp() * img_f @ txt_f.T
        return logits_per_image, logits_per_image.T


CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess_from_synth(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Generator output ([-1, 1] NHWC) → CLIP-normalised ``size``² NHWC.

    The resize is `jax.image.resize(method="cubic")` of the JAX package: a
    Keys cubic (a = -0.5) widened by the scale when shrinking (its default
    ``antialias=True``), which is PyTorch's antialiased bicubic.
    """
    n, h, w, c = images.shape
    x = ((images + 1) / 2).clamp(0, 1)
    if (h, w) != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                          antialias=True, align_corners=False).permute(0, 2, 3, 1)
    mean, std = (torch.as_tensor(a, device=x.device) for a in (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD))
    return (x - mean) / std


# ------------------------------------------------------------- converter

def _ln_into(p, state, out, key):
    put(p, f"{out}/scale", state[f"{key}.weight"])
    put(p, f"{out}/bias", state[f"{key}.bias"])


def _block_into(p, state, out, key):
    put(p, f"{out}/attn/in_proj/kernel", dense_w(state[f"{key}.attn.in_proj_weight"]))
    put(p, f"{out}/attn/in_proj/bias", state[f"{key}.attn.in_proj_bias"])
    put(p, f"{out}/attn/out_proj/kernel", dense_w(state[f"{key}.attn.out_proj.weight"]))
    put(p, f"{out}/attn/out_proj/bias", state[f"{key}.attn.out_proj.bias"])
    _ln_into(p, state, f"{out}/ln_1", f"{key}.ln_1")
    _ln_into(p, state, f"{out}/ln_2", f"{key}.ln_2")
    put(p, f"{out}/c_fc/kernel", dense_w(state[f"{key}.mlp.c_fc.weight"]))
    put(p, f"{out}/c_fc/bias", state[f"{key}.mlp.c_fc.bias"])
    put(p, f"{out}/c_proj/kernel", dense_w(state[f"{key}.mlp.c_proj.weight"]))
    put(p, f"{out}/c_proj/bias", state[f"{key}.mlp.c_proj.bias"])


def convert_clip_visual_state(state: Mapping[str, np.ndarray]) -> dict:
    """OpenAI CLIP state dict (the ``visual.*`` subset suffices) → the visual
    trunk's variables ``{"params": ...}`` (12 blocks)."""
    p: dict = {}
    put(p, "visual_conv1/kernel", np.asarray(state["visual.conv1.weight"]).transpose(2, 3, 1, 0))
    put(p, "class_embedding", state["visual.class_embedding"])
    put(p, "visual_positional_embedding", state["visual.positional_embedding"])
    _ln_into(p, state, "ln_pre", "visual.ln_pre")
    for i in range(12):
        _block_into(p, state, f"visual_transformer/resblock_{i}",
                    f"visual.transformer.resblocks.{i}")
    return {"params": p}


def convert_clip_state(state: Mapping[str, np.ndarray]) -> dict:
    """OpenAI CLIP state dict → the variables of a `CLIP` (12 + 12 blocks),
    for `load_jax_variables`."""
    p: dict = dict(convert_clip_visual_state(state)["params"])
    _ln_into(p, state, "ln_post", "visual.ln_post")
    put(p, "visual_proj", state["visual.proj"])
    put(p, "token_embedding/embedding", state["token_embedding.weight"])
    put(p, "positional_embedding", state["positional_embedding"])
    for i in range(12):
        _block_into(p, state, f"transformer/resblock_{i}", f"transformer.resblocks.{i}")
    _ln_into(p, state, "ln_final", "ln_final")
    put(p, "text_projection", state["text_projection"])
    put(p, "logit_scale", state["logit_scale"])
    return {"params": p}


def clip_widths(state: Mapping[str, np.ndarray]) -> dict:
    """A `CLIP`'s widths read off an OpenAI state dict's shapes, as the
    reference's ``build_model`` reads them (heads = width // 64)."""
    def blocks(prefix):
        return sum(1 for k in state if k.startswith(prefix) and k.endswith(".attn.in_proj_weight"))

    vision_width, _, patch, _ = np.shape(state["visual.conv1.weight"])
    grid = round((np.shape(state["visual.positional_embedding"])[0] - 1) ** 0.5)
    text_width = np.shape(state["ln_final.weight"])[0]
    return dict(embed_dim=np.shape(state["text_projection"])[1], image_resolution=grid * patch,
                vision_width=vision_width, vision_layers=blocks("visual.transformer."),
                vision_patch=patch, text_width=text_width, text_layers=blocks("transformer."),
                text_heads=text_width // 64)


def load_clip_weights(path, device: DeviceLike = None) -> CLIP:
    """A `CLIP` filled from an OpenAI state dict saved with `torch.save`
    (read with ``weights_only=True``), its widths read off the dict."""
    from ..sg3 import load_jax_variables

    state = {k: v.float().numpy()
             for k, v in torch.load(path, map_location="cpu", weights_only=True).items()}
    model = CLIP(device=device, **clip_widths(state))
    load_jax_variables(model, convert_clip_state(state))
    return model


# ------------------------------------------------------------- tokenizer

@lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


# Unicode's White_Space property: what ``\s`` matches in the ``regex`` package.
_WHITE_SPACE = frozenset(map(chr, (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))
# The pattern's literal alternatives, in its order. It is matched case-blind
# on lowercased text, where only "ſ" (U+017F) folds onto one of their letters.
_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_FOLD = {"ſ": "s"}
# The one code point that no class of the case-blind pattern takes: U+0345
# (a combining mark) folds to a letter (ι), so ``[^\s\p{L}\p{N}]`` refuses
# it, while ``[\p{L}]`` does not take it either. ``findall`` skips it.
_UNMATCHED = frozenset("\u0345")


def _kind(ch: str) -> str:
    """'s' (white space, or a character no class takes), 'L' (a letter),
    'N' (a number) or 'o' (other)."""
    if ch in _WHITE_SPACE or ch in _UNMATCHED:
        return "s"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "o"


def _pre_tokens(text: str):
    """What ``regex.findall`` of the JAX tokenizer's pattern
    ``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
    (case-blind) gives: at each position the first alternative that
    matches, in the pattern's order; a position none matches (white space)
    is skipped."""
    out, i, n = [], 0, len(text)
    while i < n:
        for lit in _LITERALS:
            seg = text[i:i + len(lit)]
            if len(seg) == len(lit) and all(_FOLD.get(a, a) == b for a, b in zip(seg, lit)):
                out.append(seg)
                i += len(lit)
                break
        else:
            kind = _kind(text[i])
            if kind == "s":
                i += 1
                continue
            j = i + 1
            if kind != "N":  # letters run on; so do the others; a number is one char
                while j < n and _kind(text[j]) == kind:
                    j += 1
            out.append(text[i:j])
            i = j
    return out


def _collapse_space(text: str) -> str:
    """``regex.sub(r"\\s+", " ", text)``."""
    out, prev = [], False
    for ch in text:
        space = ch in _WHITE_SPACE
        if not (space and prev):
            out.append(" " if space else ch)
        prev = space
    return "".join(out)


class SimpleTokenizer:
    """CLIP BPE tokenizer over a ``bpe_simple_vocab_16e6.txt.gz``-format
    merges file."""

    def __init__(self, bpe_path: str):
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str):
        tokens = []
        text = html.unescape(html.unescape(text))
        text = _collapse_space(text.strip()).lower()
        for tok in _pre_tokens(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return tokens

    def tokenize(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [sot] + self.encode(text) + [eot]
            toks = toks[:context_length]
            if len(toks) == context_length:
                toks[-1] = eot
            result[i, :len(toks)] = toks
        return result


class CLIPViTStages(nn.Module):
    """CLIP ViT-B/32's visual trunk sliced into the 4-stage feature contract.

    The JAX package's `CLIPViTStages` (the reference's ViT feature networks
    with their hooks): the tokens after blocks 2, 5, 8 and 11, the class
    token dropped, laid out on the 7×7 patch grid, then one head per stage:
    a 1×1 conv to 96, 192, 384 and 768 channels and a transposed conv ×8,
    ×4, ×2 (none at /32), so the stages sit at /4, /8, /16, /32. The heads
    keep their random init; the trunk's names are `CLIP`'s, so
    `convert_clip_visual_state` fills it. The input must be 224²: the
    registry fixes that size, and the JAX package's position-embedding
    resize for other sizes is not ported.
    """

    WIDTH, LAYERS, PATCH, GRID = 768, 12, 32, 7
    HOOKS, STAGE_CH, UPS = (2, 5, 8, 11), (96, 192, 384, 768), (8, 4, 2, 1)

    def __init__(self, generator: Optional[torch.Generator] = None):
        from .deit import ConvTranspose

        super().__init__()
        width, scale = self.WIDTH, self.WIDTH ** -0.5
        self.visual_conv1 = Conv2d(3, width, self.PATCH, stride=self.PATCH, generator=generator,
                                   use_bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn((width,), generator=generator))
        self.visual_positional_embedding = nn.Parameter(
            scale * torch.randn((self.GRID ** 2 + 1, width), generator=generator))
        self.ln_pre = LayerNorm(width)
        self.visual_transformer = Transformer(width, self.LAYERS, width // 64, generator)
        for si, (ch, up) in enumerate(zip(self.STAGE_CH, self.UPS)):
            self.add_module(f"head{si}_proj", Conv2d(width, ch, 1, generator=generator))
            if up > 1:
                self.add_module(f"head{si}_up", ConvTranspose(ch, ch, up, generator))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        n, hh, ww, _ = x.shape
        side, grid, width = self.GRID * self.PATCH, self.GRID, self.WIDTH
        if (hh, ww) != (side, side):
            raise ValueError(f"CLIPViTStages takes {side}x{side} inputs (a {grid}x{grid} token "
                             f"grid), got {hh}x{ww}")
        with fp32_matmul():
            tok = self.visual_conv1(x).reshape(n, grid * grid, width)
            cls = self.class_embedding[None, None].expand(n, 1, width)
            tok = torch.cat([cls, tok], dim=1) + self.visual_positional_embedding[None]
            _, taps = self.visual_transformer(self.ln_pre(tok), hooks=self.HOOKS)
        outs = []
        for si, tap in enumerate(taps):
            fmap = getattr(self, f"head{si}_proj")(tap[:, 1:].reshape(n, grid, grid, width))
            if self.UPS[si] > 1:
                fmap = getattr(self, f"head{si}_up")(fmap)
            outs.append(fmap)
        return outs
