"""Static configuration + layer-layout math for the alias-free generator.

All geometry (cutoff/stopband schedules, sampling rates, channel widths,
filter taps, paddings) is computed here on the host with NumPy, producing
frozen per-layer specs the PyTorch modules consume. A copy of the JAX
package's `models/sg3/config.py` (which the port may not import), equal to it
value for value: the Fourier buffers come from `np.random.RandomState`, so
they match bit for bit. Parity: reference `SynthesisNetwork.__init__` and
`SynthesisLayer.__init__`; presets match the reference `SG3Generator`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

from ...ops.filter_design import design_lowpass_filter


@dataclasses.dataclass(frozen=True)
class SG3Config:
    """Full static configuration of a StyleGAN3 generator."""

    # Latent dims.
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512

    # Output.
    img_resolution: int = 1024
    img_channels: int = 3

    # Synthesis capacity / schedule.
    channel_base: int = 32768
    channel_max: int = 512
    num_layers: int = 14
    num_critical: int = 2
    first_cutoff: float = 2.0
    first_stopband: float = 2 ** 2.1
    last_stopband_rel: float = 2 ** 0.3
    margin_size: int = 10
    output_scale: float = 0.25
    num_fp16_res: int = 4  # Number of top resolutions run in bf16.

    # Per-layer hyperparameters.
    conv_kernel: int = 3
    filter_size: int = 6
    lrelu_upsampling: int = 2
    use_radial_filters: bool = False
    conv_clamp: Optional[float] = 256.0
    magnitude_ema_beta: float = 0.999

    # Mapping network.
    mapping_layers: int = 2
    mapping_lr_multiplier: float = 0.01
    w_avg_beta: float = 0.998

    # Run the `num_fp16_res` highest resolutions in bfloat16.
    use_bf16: bool = True

    # Seed for the Fourier-feature frequency/phase buffers (overwritten by
    # checkpoint loads; only matters for from-scratch init).
    fourier_seed: int = 0

    @property
    def num_ws(self) -> int:
        return self.num_layers + 2


def sg3_r_config(res: int = 1024, **overrides) -> SG3Config:
    """StyleGAN3-R (rotation-equivariant) preset — FFHQ/AFHQ family."""
    kwargs = dict(
        img_resolution=res,
        channel_base=65536,
        channel_max=1024,
        conv_kernel=1,
        filter_size=6,
        use_radial_filters=True,
        output_scale=0.25,
        magnitude_ema_beta=0.9988915792636801,
    )
    kwargs.update(overrides)
    return SG3Config(**kwargs)


def sg3_t_config(res: int = 1024, **overrides) -> SG3Config:
    """StyleGAN3-T (translation-equivariant) preset — landscapes config."""
    kwargs = dict(
        img_resolution=res,
        channel_base=32768,
        channel_max=512,
        magnitude_ema_beta=0.9988915792636801,
    )
    kwargs.update(overrides)
    return SG3Config(**kwargs)


@dataclasses.dataclass(eq=False)
class InputSpec:
    """Static spec of the Fourier-feature input stage."""

    w_dim: int
    channels: int
    size: Tuple[int, int]  # (width, height)
    sampling_rate: float
    bandwidth: float
    freqs: np.ndarray  # [channels, 2] init values (buffer)
    phases: np.ndarray  # [channels] init values (buffer)


@dataclasses.dataclass(eq=False)
class LayerSpec:
    """Static spec of one synthesis layer (conv + filtered lrelu)."""

    name: str
    idx: int
    is_torgb: bool
    is_critically_sampled: bool
    use_bf16: bool
    in_channels: int
    out_channels: int
    in_size: Tuple[int, int]
    out_size: Tuple[int, int]
    in_sampling_rate: int
    out_sampling_rate: int
    in_cutoff: float
    out_cutoff: float
    in_half_width: float
    out_half_width: float
    conv_kernel: int
    up_factor: int
    down_factor: int
    up_taps: int
    down_taps: int
    up_radial: bool
    down_radial: bool
    up_filter: Optional[np.ndarray]
    down_filter: Optional[np.ndarray]
    padding: Tuple[int, int, int, int]  # (px0, px1, py0, py1)
    conv_clamp: Optional[float]
    magnitude_ema_beta: float
    w_dim: int


@dataclasses.dataclass(eq=False)
class SynthesisLayout:
    input: InputSpec
    layers: Tuple[LayerSpec, ...]
    num_ws: int


def _sample_disc_freqs(channels: int, bandwidth: float, seed: int):
    """Random frequencies from a uniform 2-D disc of radius `bandwidth`.

    A Gaussian direction normalized onto the disc with density correction —
    matches the reference init distribution (networks_stylegan3.py:183-188).
    """
    rng = np.random.RandomState(seed)
    freqs = rng.randn(channels, 2)
    radii = np.sqrt(np.sum(np.square(freqs), axis=1, keepdims=True))
    freqs = freqs / (radii * np.exp(np.square(radii)) ** 0.25)
    freqs = freqs * bandwidth
    phases = rng.rand(channels) - 0.5
    return freqs.astype(np.float32), phases.astype(np.float32)


@functools.lru_cache(maxsize=16)
def build_synthesis_layout(cfg: SG3Config) -> SynthesisLayout:
    """Compute the full static layout of the synthesis network."""
    res = cfg.img_resolution

    # Geometric progression of cutoffs f_c[i] and stopbands f_t[i].
    last_cutoff = res / 2
    last_stopband = last_cutoff * cfg.last_stopband_rel
    exponents = np.minimum(
        np.arange(cfg.num_layers + 1) / (cfg.num_layers - cfg.num_critical), 1)
    cutoffs = cfg.first_cutoff * (last_cutoff / cfg.first_cutoff) ** exponents
    stopbands = cfg.first_stopband * (last_stopband / cfg.first_stopband) ** exponents

    # Sampling rates s[i], transition half-widths f_h[i], canvas sizes, widths.
    sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
    sizes = sampling_rates + cfg.margin_size * 2
    sizes[-2:] = res
    channels = np.rint(np.minimum((cfg.channel_base / 2) / cutoffs, cfg.channel_max))
    channels[-1] = cfg.img_channels

    freqs, phases = _sample_disc_freqs(int(channels[0]), cutoffs[0], cfg.fourier_seed)
    input_spec = InputSpec(
        w_dim=cfg.w_dim,
        channels=int(channels[0]),
        size=(int(sizes[0]), int(sizes[0])),
        sampling_rate=float(sampling_rates[0]),
        bandwidth=float(cutoffs[0]),
        freqs=freqs,
        phases=phases,
    )

    layers = []
    for idx in range(cfg.num_layers + 1):
        prev = max(idx - 1, 0)
        is_torgb = idx == cfg.num_layers
        is_crit = idx >= cfg.num_layers - cfg.num_critical
        use_bf16 = cfg.use_bf16 and (
            sampling_rates[idx] * (2 ** cfg.num_fp16_res) > res)
        in_sr, out_sr = int(sampling_rates[prev]), int(sampling_rates[idx])
        tmp_sr = max(in_sr, out_sr) * (1 if is_torgb else cfg.lrelu_upsampling)
        in_cut, out_cut = float(cutoffs[prev]), float(cutoffs[idx])
        in_hw, out_hw = float(half_widths[prev]), float(half_widths[idx])
        conv_kernel = 1 if is_torgb else cfg.conv_kernel

        up_factor = int(np.rint(tmp_sr / in_sr))
        assert in_sr * up_factor == tmp_sr
        up_taps = cfg.filter_size * up_factor if (up_factor > 1 and not is_torgb) else 1
        up_filter = design_lowpass_filter(
            numtaps=up_taps, cutoff=in_cut, width=in_hw * 2, fs=tmp_sr)

        down_factor = int(np.rint(tmp_sr / out_sr))
        assert out_sr * down_factor == tmp_sr
        down_taps = cfg.filter_size * down_factor if (down_factor > 1 and not is_torgb) else 1
        down_radial = cfg.use_radial_filters and not is_crit
        down_filter = design_lowpass_filter(
            numtaps=down_taps, cutoff=out_cut, width=out_hw * 2, fs=tmp_sr,
            radial=down_radial)

        in_size = (int(sizes[prev]), int(sizes[prev]))
        out_size = (int(sizes[idx]), int(sizes[idx]))
        # Padding on the tmp (upsampled) grid so the output lands on the
        # desired canvas; the +up_factor shifts sample locations per the
        # symmetric interpretation (alias-free GAN paper, App. C.3).
        pad_total_x = (out_size[0] - 1) * down_factor + 1
        pad_total_x -= (in_size[0] + conv_kernel - 1) * up_factor
        pad_total_x += up_taps + down_taps - 2
        pad_lo_x = (pad_total_x + up_factor) // 2
        pad_hi_x = pad_total_x - pad_lo_x
        pad_total_y = (out_size[1] - 1) * down_factor + 1
        pad_total_y -= (in_size[1] + conv_kernel - 1) * up_factor
        pad_total_y += up_taps + down_taps - 2
        pad_lo_y = (pad_total_y + up_factor) // 2
        pad_hi_y = pad_total_y - pad_lo_y

        spec = LayerSpec(
            name=f"L{idx}_{out_size[0]}_{int(channels[idx])}",
            idx=idx,
            is_torgb=is_torgb,
            is_critically_sampled=is_crit,
            use_bf16=bool(use_bf16),
            in_channels=int(channels[prev]),
            out_channels=int(channels[idx]),
            in_size=in_size,
            out_size=out_size,
            in_sampling_rate=in_sr,
            out_sampling_rate=out_sr,
            in_cutoff=in_cut,
            out_cutoff=out_cut,
            in_half_width=in_hw,
            out_half_width=out_hw,
            conv_kernel=conv_kernel,
            up_factor=up_factor,
            down_factor=down_factor,
            up_taps=up_taps,
            down_taps=down_taps,
            up_radial=False,
            down_radial=down_radial,
            up_filter=up_filter,
            down_filter=down_filter,
            padding=(int(pad_lo_x), int(pad_hi_x), int(pad_lo_y), int(pad_hi_y)),
            conv_clamp=cfg.conv_clamp,
            magnitude_ema_beta=cfg.magnitude_ema_beta,
            w_dim=cfg.w_dim,
        )
        layers.append(spec)

    return SynthesisLayout(input=input_spec, layers=tuple(layers),
                           num_ws=cfg.num_layers + 2)
