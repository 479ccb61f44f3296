"""Train SetGAN (CLI).

The port of the JAX package's `scripts/train_setgan.py` (reference
train_setgan.py): the options → `SetGANTrainer.train` over a class-per-folder
image root (or a named ``--dataset``), ticks, snapshots and a ``final``
snapshot. It runs on the CUDA card unless ``--device cpu`` is given, in one
process.

    python -m stylegan3_editing_tpu_torch.scripts.train_setgan --data DIR \\
        --outdir OUT [--fid false] [--inception_path INCEPTION] [--device cpu]

``--fid true`` (the default) evaluates the class-conditional FID every
``--eval_ticks`` ticks (`make_fid_eval_fn`; the best one snapshots
``best_model``) with InceptionV3 features: the weights from
``--inception_path`` (a tree saved by `runtime.checkpoint.save_pytree`, as
`convert_inception` gives it), else a seeded init, whose FIDs cannot be
compared with published ones.

The recipes' other phases: ``--superres true --path_stem SNAPSHOT`` grows
the decoder of a stem run's snapshot by ``--up_factor`` with
``--head_layers`` new layers (`models/sg3/superres.superres_config`; the
stem's config from the snapshot's ``decoder_cfg``, else the CLI recipe at
``--resolution / --up_factor``), carries the stem's weights where name and
shape match (`reinit_stem`) and trains the head layers only.
``--encoder_path`` loads a pretrained ReStyle encoder (a reference
``.pt``/``.pth``, or a coach checkpoint) the same way, and
``--generator_path`` a decoder (an ``.npz`` from `convert_checkpoint`, or
a reference ``.pt`` state dict). Refused before any work: ``--devices``
above 1 (the multi-card runtime, Queue 1 #10) and ``--pl_weight > 0``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..models.sg3 import SG3Config, sg3_t_config
from ..models.sg3.convert import load_torch_pt, npz_to_variables
from ..models.sg3.superres import head_layer_names, superres_config
from ..runtime.checkpoint import load_pytree
from ..runtime.profiling import maybe_start_trace, stop_trace
from ..setgan.dataset import ImageMultiSetGenerator, SafeClassImageDataset, build_datasets
from ..setgan.loss import SetGANLossConfig
from ..setgan.metrics import ConditionalFID
from ..setgan.training_loop import SetGANTrainConfig, SetGANTrainer
from ..utils.cli import parse_dataclass


@dataclasses.dataclass
class SetGANCliOptions:
    outdir: str = "./experiments/setgan"
    data: str = "./data"
    # A named dataset layout (celeba, celeba-ident, imagenet, vggface,
    # animalfaces, flowers, cifar100, mini-imagenet); empty: --data holds a
    # folder per class.
    dataset: Optional[str] = None
    data_augmentation: bool = False  # set-consistent flips and rotations
    resolution: int = 256
    total_kimg: float = 10000
    encoder_res: int = 256
    devices: Optional[int] = None
    batch: int = 8
    reference_min: int = 7
    reference_max: int = 12
    candidate_min: int = 1
    candidate_max: int = 4
    stem: str = "sg3"
    # Comma-separated feature networks for D; empty: DeiT-base-distilled +
    # EfficientNet-lite0.
    backbones: Optional[str] = None
    glr: float = 0.0025
    dlr: float = 0.002
    ema_kimg: float = 10.0
    tick_kimg: float = 4.0
    snapshot_ticks: int = 50
    eval_ticks: int = 50
    # D sees blurred images early, fading out over 300 kimg (σ in steps of 0.1).
    blur_init_sigma: float = 2.0
    blur_fade_kimg: float = 300.0
    pl_weight: float = 0.0
    seed: int = 0
    resume: Optional[str] = None
    ada_target: Optional[float] = None
    generator_path: Optional[str] = None  # a converted generator (.npz) or a reference .pt
    superres: bool = False
    head_layers: int = 7
    up_factor: int = 2
    path_stem: Optional[str] = None
    freeze_encoder: bool = False
    freeze_decoder: bool = False
    encoder_path: Optional[str] = None
    restyle_mode: str = "none"  # none | encoder
    restyle_iters: int = 3
    g_attn_heads: int = 4
    g_attn_layers: int = 2
    d_attn_heads: int = 4
    d_attn_layers: int = 2
    d_latent: int = 512
    d_remat_features: bool = False
    g_remat_encoder: bool = False
    use_set_decoder: bool = True
    use_temperature: bool = False
    disable_style_concat: bool = False
    no_mean_center: bool = False
    encoder_type: str = "ProgressiveBackboneEncoder"
    encoder_num_layers: int = 50
    inception_path: Optional[str] = None
    fid: bool = True
    fid_classes: int = 8
    fid_mode: str = "agg"  # agg | sfid | rfid
    cbase: int = 16384
    cmax: int = 256
    syn_layers: int = 7
    fid_items_per_class: int = 256
    device: Optional[str] = None  # cuda unless "cpu"


def check_options(opts: SetGANCliOptions) -> None:
    """Refuse what the port cannot do yet, before any work."""
    if opts.devices is not None and opts.devices > 1:
        raise NotImplementedError("--devices > 1 needs the multi-card runtime "
                                  "(ROADMAP Queue 1 #10, slice 19)")
    if opts.superres and not opts.path_stem:
        raise ValueError("--superres needs --path_stem (a stem run's snapshot)")
    if opts.pl_weight > 0:
        raise NotImplementedError(
            "--pl_weight > 0 needs path-length regularisation: a double-differentiable "
            "device.conv2d backward and a backward for #2 (ROADMAP Queue 1)")


def make_fid_eval_fn(opts: SetGANCliOptions, dataset) -> Callable[[SetGANTrainer], float]:
    """The in-loop class-conditional FID: each call draws ``fid_classes``
    classes (``np.random.RandomState(seed + 7)``, one stream over the run),
    takes up to 16 items of each (``fid_items_per_class`` at most), renders
    as many candidates from G_ema with the first half of them as the
    references, and returns the ``fid_mode`` FID of InceptionV3's pool3
    features."""
    from ..models.backbones.inception import inception_feature_fn

    variables = load_pytree(opts.inception_path)[0] if opts.inception_path else None
    feature_fn = inception_feature_fn(variables, device=opts.device)
    rng = np.random.RandomState(opts.seed + 7)

    def eval_fn(trainer: SetGANTrainer) -> float:
        fid = ConditionalFID(feature_fn, max_items_per_class=opts.fid_items_per_class)
        n_classes = min(opts.fid_classes, len(dataset.classes))
        per = min(opts.fid_items_per_class, 16)
        for idx in rng.choice(len(dataset.classes), n_classes, replace=False):
            paths = dataset.class_to_paths[dataset.classes[int(idx)]][:per]
            real = np.stack([dataset.load(p) for p in paths])
            refs = real[None, :max(len(real) // 2, 1)]
            fakes = trainer.generate(refs, num_candidates=len(real), use_ema=True)
            fid.append_real(int(idx), real)
            fid.append_fake(int(idx), np.asarray(fakes[0]))
        return fid.compute(opts.fid_mode)

    return eval_fn


def load_encoder_variables(path: str) -> dict:
    """A pretrained ReStyle encoder's variables: a reference ``.pt``/``.pth``
    (released ``restyle_{psp,e4e}`` weights, or the ``encoder.*`` keys of a
    full-model checkpoint) through `convert_restyle_encoder_state`, else a
    coach checkpoint's ``variables[col]["encoder"]`` subtrees."""
    if path.endswith((".pt", ".pth")):
        import torch

        from ..models.encoders import (convert_restyle_encoder_state,
                                       encoder_state_from_model_checkpoint)

        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return convert_restyle_encoder_state(encoder_state_from_model_checkpoint(ckpt))[0]
    tree, _ = load_pytree(path)
    src = tree.get("variables", tree)
    return {col: src[col]["encoder"] for col in src
            if isinstance(src[col], dict) and "encoder" in src[col]}


def load_generator_variables(path: str, cfg: SG3Config) -> dict:
    """A decoder's variables: an ``.npz`` from `convert_checkpoint`, else a
    reference ``.pt`` state dict for ``cfg`` (`load_torch_pt`)."""
    if path.endswith(".npz"):
        return npz_to_variables(path)
    return load_torch_pt(path, cfg)[0]


def stem_config(opts: SetGANCliOptions, meta: Optional[dict]) -> SG3Config:
    """The stem's config: the snapshot's ``decoder_cfg``, else (an older
    snapshot) the CLI recipe at ``resolution // up_factor``."""
    if meta and meta.get("decoder_cfg"):
        fields = {f.name for f in dataclasses.fields(SG3Config)}  # a JAX snapshot adds `remat`
        return SG3Config(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in meta["decoder_cfg"].items() if k in fields})
    return sg3_t_config(opts.resolution // opts.up_factor, channel_base=opts.cbase,
                        channel_max=opts.cmax, num_layers=opts.syn_layers)


def build_trainer(opts: SetGANCliOptions) -> SetGANTrainer:
    decoder_cfg = sg3_t_config(opts.resolution, channel_base=opts.cbase,
                               channel_max=opts.cmax, num_layers=opts.syn_layers)
    gen_vars = (load_generator_variables(opts.generator_path, decoder_cfg)
                if opts.generator_path else None)
    stem_vars, superres = None, {}
    if opts.superres:
        stem_tree, meta = load_pytree(opts.path_stem)
        stem_cfg = stem_config(opts, meta)
        decoder_cfg = superres_config(stem_cfg, opts.resolution, opts.head_layers)
        stem_vars = {col: stem_tree["g_vars"][col]["decoder"]
                     for col in ("params", "buffers", "ema") if col in stem_tree["g_vars"]}
        superres = dict(train_head_only=True,
                        head_layer_names=head_layer_names(decoder_cfg, stem_cfg))
    enc_vars = load_encoder_variables(opts.encoder_path) if opts.encoder_path else None
    cfg = SetGANTrainConfig(
        total_kimg=opts.total_kimg, batch_size=opts.batch, g_lr=opts.glr, d_lr=opts.dlr,
        ema_kimg=opts.ema_kimg,
        # A resumed run has no EMA ramp-up and adapts ADA faster.
        ema_rampup=None if opts.resume else 0.05, ada_target=opts.ada_target,
        ada_kimg=100.0 if opts.resume else 500.0, tick_kimg=opts.tick_kimg,
        snapshot_ticks=opts.snapshot_ticks, ref_resolution=opts.encoder_res,
        eval_ticks=opts.eval_ticks, seed=opts.seed, stem=opts.stem,
        **({"d_backbones": tuple(opts.backbones.split(","))} if opts.backbones else {}),
        freeze_encoder=opts.freeze_encoder, freeze_decoder=opts.freeze_decoder,
        restyle_mode=opts.restyle_mode, restyle_iters=opts.restyle_iters,
        g_attn_heads=opts.g_attn_heads, g_attn_layers=opts.g_attn_layers,
        d_attn_heads=opts.d_attn_heads, d_attn_layers=opts.d_attn_layers,
        d_latent_size=opts.d_latent, d_remat_features=opts.d_remat_features,
        g_remat_encoder=opts.g_remat_encoder, use_set_decoder=opts.use_set_decoder,
        use_temperature=opts.use_temperature, disable_style_concat=opts.disable_style_concat,
        mean_center=False if opts.no_mean_center else None, encoder_type=opts.encoder_type,
        encoder_num_layers=opts.encoder_num_layers, **superres,
        loss=SetGANLossConfig(blur_init_sigma=opts.blur_init_sigma,
                              blur_fade_kimg=opts.blur_fade_kimg, pl_weight=opts.pl_weight))
    return SetGANTrainer(cfg, decoder_cfg, run_dir=opts.outdir, generator_variables=gen_vars,
                         stem_variables=stem_vars, encoder_variables=enc_vars,
                         device=opts.device)


def main(opts: SetGANCliOptions) -> SetGANTrainer:
    check_options(opts)
    resolve_device(opts.device)  # no card and no --device cpu: raise before reading data
    run_dir = Path(opts.outdir)
    run_dir.mkdir(parents=True, exist_ok=True)
    if opts.dataset:
        eval_ds, dataset = build_datasets(opts.dataset, opts.data, opts.resolution)
    else:
        dataset = eval_ds = SafeClassImageDataset.from_folder(opts.data, opts.resolution)
    data = ImageMultiSetGenerator(
        dataset, batch_size=opts.batch, reference_range=(opts.reference_min, opts.reference_max),
        candidate_range=(opts.candidate_min, opts.candidate_max),
        data_augmentation=opts.data_augmentation, seed=opts.seed)
    trainer = build_trainer(opts)
    if opts.resume:
        trainer.restore(opts.resume)
    eval_fn = make_fid_eval_fn(opts, eval_ds) if opts.fid else None
    maybe_start_trace()  # a torch.profiler capture when SG3TPU_TRACE_DIR is set
    try:
        trainer.train(iter(data), eval_fn=eval_fn)
    finally:
        trace_dir = stop_trace()
        if trace_dir:
            print(f"profiler trace written to {trace_dir}")
    trainer.snapshot(run_dir / "final")
    print(f"done at {trainer.cur_nimg / 1000:.1f} kimg, best_fid={trainer.best_fid}")
    return trainer


def cli(argv: Optional[Sequence[str]] = None) -> SetGANTrainer:
    return main(parse_dataclass(SetGANCliOptions, argv))


if __name__ == "__main__":
    cli()
