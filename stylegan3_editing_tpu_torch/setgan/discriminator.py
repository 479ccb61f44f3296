"""Projected set discriminator: frozen feature backbones, random projections,
per-scale set comparisons.

Counterpart of the JAX package's `setgan/discriminator.py` (reference
models/setgan/discriminator.py and projected-GAN's F_RandomProj). For each
backbone the candidates are DiffAugmented (with probability ``ada_p``
under ADA), both sets are normalised by the backbone's statistics and,
where ``interp224`` or a ViT's fixed size asks, resized to 224²; the
frozen trunk's 4 stages go through random cross-channel (CCM, 1×1) and
cross-scale (CSM, top-down) mixing; per scale a `SingleDisc` embeds each
image and a `MultiSetComparator` scores the reference set against the
candidate set. The logits are ``[B, backbones × num_discs]``.

Parameters carry the flax names (``proj_<backbone>.backbone…``,
``proj_<backbone>.ccm0…``, ``d_<backbone>.disc0.down0…``,
``d_<backbone>.set0.encoder…``), so `models.sg3.load_jax_variables` fills
a discriminator from the JAX package's variables. The projector never
trains (`projector_param_mask` lists what does). Every conv runs through
`device.conv2d`, every product in full fp32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, fp32_matmul, resolve_device
from ..models.backbones import registry as fn_registry
from ..models.backbones.common import Conv2d, Dense
from ..models.backbones.vgg import N_CHANNELS as VGG_CHANNELS
from ..models.backbones.vgg import VGG16Features
from ..ops.image import resize_bilinear
from .ada import apply_ada
from .diffaugment import apply_augment, draw_augment
from .model import to_images, to_set
from .set_transformer import PMA, MultiSetTransformerEncoder

# The midas-style channel schedule of the down stacks, by feature-map size.
_NFC_MIDAS = {4: 512, 8: 512, 16: 256, 32: 128, 64: 64, 128: 64, 256: 32, 512: 16, 1024: 8}
GROUP_NORM_EPS = 1e-6  # flax nn.GroupNorm's default

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_INCEPTION_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
_INCEPTION_STD = np.array([0.5, 0.5, 0.5], np.float32)


class TinyFeatures(nn.Module):
    """A minimal 4-stage conv feature net (/2, /4, /8, /16; 8–64 channels)
    for tests and dry runs; not a reference backbone."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        in_c = 3
        for i, c in enumerate((8, 16, 32, 64)):
            self.add_module(f"conv{i}", Conv2d(in_c, c, 3, 2, 1, generator=generator))
            in_c = c

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
        return feats


# Direct entries (the 5-stage VGG, sliced by the projector, and the tiny
# net); every other name resolves through the feature-network registry.
BACKBONES = {
    "vgg16_proj": (VGG16Features, _IMAGENET_MEAN, _IMAGENET_STD),
    "tiny_proj": (TinyFeatures, _INCEPTION_MEAN, _INCEPTION_STD),
}
_BACKBONE_CHANNELS = {"vgg16_proj": tuple(VGG_CHANNELS[1:]), "tiny_proj": (8, 16, 32, 64)}
# The first feature stage's downsampling (registry backbones start at /4).
_FIRST_STAGE_STRIDE = {"vgg16_proj": 2, "tiny_proj": 2}


def resolve_backbone(name: str):
    """name → (module factory, mean, std), from `BACKBONES` or the registry."""
    if name in BACKBONES:
        return BACKBONES[name]
    spec = fn_registry.get_spec(name)
    return spec.make, spec.mean, spec.std


def backbone_fixed_res(name: str) -> Optional[int]:
    """The input size a ViT family needs whatever ``interp224`` says (None: any)."""
    if name in BACKBONES:
        return None
    return fn_registry.get_spec(name).fixed_input_res


def backbone_channels(name: str) -> Tuple[int, ...]:
    """The 4 stage outputs' channels the projector gets from ``name``."""
    if name in _BACKBONE_CHANNELS:
        return _BACKBONE_CHANNELS[name]
    return fn_registry.get_spec(name).channels


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=None, group_size=1)``: each channel of
    each image normalised over H, W (the variance as E[x²] − E[x]², floored
    at 0), then ``scale`` and ``bias``; ε 1e-6."""

    def __init__(self, channels: int, epsilon: float = GROUP_NORM_EPS):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = ((x * x).mean(dim=(1, 2), keepdim=True) - mean * mean).clamp_min(0)
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


class FeatureProjector(nn.Module):
    """The frozen backbone's 4 stages → random CCM (1×1) and CSM (top-down
    fusion: the deeper map resized bilinearly, a 1×1 conv, added, ReLU,
    a 3×3 conv). ``remat`` recomputes the trunk in the backward
    (`torch.utils.checkpoint`) instead of keeping its activations."""

    def __init__(self, backbone: str = "vgg16_proj", cout: int = 64, proj_type: int = 2,
                 expand: bool = True, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone_name, self.proj_type, self.remat = backbone, proj_type, remat
        self.backbone = resolve_backbone(backbone)[0](generator=generator)
        feats = backbone_channels(backbone)
        couts = [cout, cout * 2, cout * 4, cout * 8] if expand else [cout] * 4
        csm = [cout, cout, cout * 2, cout * 4] if expand else [cout] * 4
        self.out_channels = list(feats) if proj_type == 0 else \
            couts if proj_type == 1 else csm
        if proj_type >= 1:
            for i in range(4):
                self.add_module(f"ccm{i}", Conv2d(feats[i], couts[i], 1, generator=generator))
        if proj_type == 2:
            for i in (3, 2, 1, 0):
                if i < 3:
                    self.add_module(f"csm_lat{i}", Conv2d(csm[i + 1], couts[i], 1,
                                                          generator=generator))
                self.add_module(f"csm{i}", Conv2d(couts[i], csm[i], 3, 1, 1,
                                                  generator=generator))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.remat and torch.is_grad_enabled():
            feats = checkpoint(self.backbone, x, use_reentrant=False)
        else:
            feats = self.backbone(x)
        if self.backbone_name == "vgg16_proj":
            feats = feats[1:]  # 4 stages: /2 … /16
        if self.proj_type == 0:
            return {str(i): f for i, f in enumerate(feats)}
        ccm = [getattr(self, f"ccm{i}")(feats[i]) for i in range(4)]
        if self.proj_type == 1:
            return {str(i): ccm[i] for i in range(4)}
        out: List[Optional[torch.Tensor]] = [None] * 4
        prev = None
        for i in (3, 2, 1, 0):
            y = ccm[i]
            if prev is not None:
                y = y + getattr(self, f"csm_lat{i}")(resize_bilinear(prev, tuple(y.shape[1:3])))
            prev = out[i] = getattr(self, f"csm{i}")(F.relu(y))
        return {str(i): out[i] for i in range(4)}


class SingleDisc(nn.Module):
    """Down-block stack collapsing a feature map to a vector: stride-2 4×4
    convs (channels by `_NFC_MIDAS`), GroupNorm and leaky ReLU 0.2 from the
    schedule's size nearest ``start_sz`` down to ``end_sz``, then a 4×4
    VALID conv summed over the map."""

    def __init__(self, in_channels: int, start_sz: int, end_sz: int = 8,
                 out_features: int = 512, generator: Optional[torch.Generator] = None):
        super().__init__()
        sizes = np.array(list(_NFC_MIDAS.keys()))
        sz = int(sizes[np.argmin(np.abs(sizes - start_sz))])
        self.n_down = 0
        while sz > end_sz:
            out = _NFC_MIDAS[sz // 2]
            self.add_module(f"down{self.n_down}", Conv2d(in_channels, out, 4, 2, 1,
                                                         generator=generator, use_bias=False))
            self.add_module(f"norm{self.n_down}", GroupNorm(out))
            in_channels, sz, self.n_down = out, sz // 2, self.n_down + 1
        self.out_conv = Conv2d(in_channels, out_features, 4, generator=generator,
                               use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_down):
            x = F.leaky_relu(getattr(self, f"norm{i}")(getattr(self, f"down{i}")(x)), 0.2)
        return self.out_conv(x).sum(dim=(1, 2))  # [N, out_features]


class MultiSetComparator(nn.Module):
    """Reference set against candidate set: a joint multi-set encoder, a
    pooling of each set (masked mean with set masks; ``"pma"`` or
    ``"max"``), the interaction ``[zr | zx | zr·zx]``, ``decoder_layers``
    ReLU layers and a linear logit ``[B, 1]``."""

    def __init__(self, latent_size: int = 512, num_heads: int = 4, num_blocks: int = 2,
                 pooling: str = "mean", decoder_layers: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pooling, self.decoder_layers = pooling, decoder_layers
        self.encoder = MultiSetTransformerEncoder(
            latent_size, latent_size, latent_size, latent_size, num_heads, num_blocks,
            ln=True, generator=generator)
        if pooling == "pma":  # the flax names: pool_x pools r, pool_y pools x
            self.pool_x = PMA(latent_size, latent_size, num_heads, 1, ln=True,
                              generator=generator)
            self.pool_y = PMA(latent_size, latent_size, num_heads, 1, ln=True,
                              generator=generator)
        width = 3 * latent_size
        for i in range(decoder_layers):
            self.add_module(f"head{i}", Dense(width, latent_size, generator))
            width = latent_size
        self.decoder = Dense(width, 1, generator)

    def forward(self, r: torch.Tensor, x: torch.Tensor, r_mask: Optional[torch.Tensor] = None,
                x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        masks = None
        if r_mask is not None or x_mask is not None:
            b, rn, xn = r.shape[0], r.shape[1], x.shape[1]
            rm = r_mask if r_mask is not None else torch.ones((b, rn), dtype=torch.bool,
                                                              device=r.device)
            xm = x_mask if x_mask is not None else torch.ones((b, xn), dtype=torch.bool,
                                                              device=x.device)
            masks = (rm[:, None, :].expand(b, rn, rn), xm[:, None, :].expand(b, rn, xn),
                     rm[:, None, :].expand(b, xn, rn), xm[:, None, :].expand(b, xn, xn))
        r_enc, x_enc = self.encoder(r, x, masks=masks)
        if self.pooling == "pma":
            zr = self.pool_x(r_enc, mask=None if masks is None else masks[0][:, :1])[:, 0]
            zx = self.pool_y(x_enc, mask=None if masks is None else masks[3][:, :1])[:, 0]
        elif self.pooling == "max":
            zr, zx = r_enc.amax(dim=1), x_enc.amax(dim=1)
        else:
            def pool(v, m):
                if m is None:
                    return v.mean(dim=1)
                m = m[:, :, None].to(v.dtype)
                return (v * m).sum(dim=1) / m.sum(dim=1).clamp_min(1)

            zr, zx = pool(r_enc, r_mask), pool(x_enc, x_mask)
        out = torch.cat([zr, zx, zr * zx], dim=-1)
        with fp32_matmul():
            for i in range(self.decoder_layers):
                out = F.relu(getattr(self, f"head{i}")(out))
            return self.decoder(out)


class MultiScaleD(nn.Module):
    """Per scale: `SingleDisc` embeddings of both sets and their
    `MultiSetComparator` logit; ``[B, num_discs]``."""

    def __init__(self, resolutions: Sequence[int], in_channels: Sequence[int],
                 latent_size: int = 512, num_discs: int = 4, attn_heads: int = 4,
                 attn_layers: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_discs = num_discs
        for i in range(num_discs):
            self.add_module(f"disc{i}", SingleDisc(in_channels[i], resolutions[i],
                                                   out_features=latent_size,
                                                   generator=generator))
            self.add_module(f"set{i}", MultiSetComparator(latent_size, attn_heads, attn_layers,
                                                          generator=generator))

    def forward(self, r_features: Dict[str, torch.Tensor], x_features: Dict[str, torch.Tensor],
                r_mask=None, x_mask=None) -> torch.Tensor:
        logits = []
        for i in range(self.num_discs):
            rf, xf = r_features[str(i)], x_features[str(i)]  # [B, S, h, w, c]
            b, disc = rf.shape[0], getattr(self, f"disc{i}")
            r_enc, x_enc = to_set(disc(to_images(rf)), b), to_set(disc(to_images(xf)), b)
            logits.append(getattr(self, f"set{i}")(r_enc, x_enc, r_mask=r_mask, x_mask=x_mask))
        return torch.cat(logits, dim=1)


class ProjectedSetDiscriminator(nn.Module):
    """DiffAugment the candidates, normalise, extract and project features
    per backbone, compare reference and candidate sets at every scale.

    ``img_resolution`` is the candidates' (and references') size, which
    sets the down stacks where nothing resizes to 224. Built on the CUDA
    card unless ``device="cpu"``; weights from ``generator`` (seed 0 by
    default)."""

    def __init__(self, img_resolution: int, latent_size: int = 512, num_discs: int = 4,
                 diffaug: bool = True, interp224: bool = True,
                 backbones: Tuple[str, ...] = ("vgg16_proj",), attn_heads: int = 4,
                 attn_layers: int = 2, remat_features: bool = False,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.img_resolution, self.diffaug, self.interp224 = img_resolution, diffaug, interp224
        self.backbones = tuple(backbones)
        self.in_res = {}
        for k, bb in enumerate(self.backbones):
            fixed = backbone_fixed_res(bb)
            in_res = (224 if interp224 else fixed) if (interp224 or fixed is not None) \
                else img_resolution
            self.in_res[bb] = in_res
            proj = FeatureProjector(backbone=bb, remat=remat_features, generator=generator)
            self.add_module(f"proj_{bb}", proj)
            res0 = in_res // _FIRST_STAGE_STRIDE.get(bb, 4)
            self.add_module(f"d_{bb}", MultiScaleD(
                [res0 // (2 ** i) for i in range(4)], proj.out_channels, latent_size, num_discs,
                attn_heads, attn_layers, generator))
            _, mean, std = resolve_backbone(bb)
            self.register_buffer(f"_mean{k}", torch.from_numpy(np.asarray(mean, np.float32)),
                                 persistent=False)
            self.register_buffer(f"_std{k}", torch.from_numpy(np.asarray(std, np.float32)),
                                 persistent=False)
        self.to(device)

    def draw(self, n: int, generator: Optional[torch.Generator] = None,
             device=None) -> Dict[str, torch.Tensor]:
        """The random numbers of one call's augmentation of ``n`` candidate
        images: DiffAugment's (`draw_augment`) and the ADA gate's ``keep_u``."""
        res = self.img_resolution
        draws = draw_augment(n, res, res, generator, device)
        draws["keep_u"] = torch.rand(n, generator=generator,
                                     device=device if generator is None else generator.device)
        return draws

    def forward(self, r: torch.Tensor, x: torch.Tensor,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                r_mask: Optional[torch.Tensor] = None, x_mask: Optional[torch.Tensor] = None,
                ada_p=None) -> torch.Tensor:
        """r ``[B, R, H, W, 3]``, x ``[B, C, H, W, 3]`` in [−1, 1] → logits
        ``[B, backbones × num_discs]``. ``draws`` (from `draw`): augment the
        candidates with them (None: no augmentation); ``ada_p``: augment
        each image only where its ``keep_u`` is below p (ADA)."""
        b = r.shape[0]
        x_flat, r_flat = to_images(x), to_images(r)
        if self.diffaug and draws is not None:
            if ada_p is not None:
                x_aug = apply_ada(x_flat, ada_p, draws=draws, keep_u=draws["keep_u"])
            else:
                x_aug = apply_augment(x_flat, draws)
        else:
            x_aug = x_flat
        all_logits = []
        for k, bb in enumerate(self.backbones):
            mean, std = getattr(self, f"_mean{k}"), getattr(self, f"_std{k}")
            x_n, r_n = ((x_aug + 1) / 2 - mean) / std, ((r_flat + 1) / 2 - mean) / std
            in_res = self.in_res[bb]
            if self.interp224 or backbone_fixed_res(bb) is not None:
                x_n, r_n = resize_bilinear(x_n, in_res), resize_bilinear(r_n, in_res)
            proj = getattr(self, f"proj_{bb}")
            x_feats = {k_: to_set(v, b) for k_, v in proj(x_n).items()}
            r_feats = {k_: to_set(v, b) for k_, v in proj(r_n).items()}
            all_logits.append(getattr(self, f"d_{bb}")(r_feats, x_feats, r_mask=r_mask,
                                                        x_mask=x_mask))
        return torch.cat(all_logits, dim=1)


def projector_param_mask(module: nn.Module) -> List[str]:
    """The names of the parameters that train: all but the frozen projector
    (``proj_*``: the backbone and the random CCM/CSM)."""
    return [name for name, _ in module.named_parameters() if not name.startswith("proj_")]
