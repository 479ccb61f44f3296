"""SetGAN training loop on one process: D step, G step, G_ema, ticks, snapshots.

Counterpart of the JAX package's `setgan/training_loop.py` (reference
setgan/training_loop.py), without its mesh: one process, one card, the
statistics local means (the multi-card runtime is ROADMAP Queue 1 #10).
One `train_step`:

- the D step: G renders the candidates under ``no_grad`` (the encoder in
  eval mode, as in every G call), the fake and the real candidates go
  through D with their own augment draws, the hinge loss, its gradient
  with NaNs scrubbed, then Adam on D's trainable parameters (the
  projector never trains);
- the G step: G with its graph, D on the blurred candidates (D's
  parameters are not differentiated), −mean logits, the gradient of G's
  trainable parameters scrubbed, then Adam with the warm-up rate
  ``g_lr · min((step + 1) / warm_steps, 1)``;
- G_ema moves towards G (``ema_kimg``, ``ema_rampup``).

Adam has β1 = 0 and β2 = ``beta2`` (optax's update). A group that does not
train (``freeze_encoder``, ``freeze_decoder``, ``train_head_only``, the
projector) is left out of the optimizer, as optax's ``set_to_zero``
leaves it, and gets no gradient at all: with a frozen decoder the
filtered-lrelu backward kernel computes dx alone. Metrics stay tensors on
the device until a tick reads them, except the real logits' sign that
ADA needs each step. The step's parts are profiler ranges (``Dmain``,
``Gmain``, ``backward``, ``adam``, ``ema``; `runtime.profiling`), whose host
times a tick reports as ``Timing/*``. ``train_step(batch, impl, z, draws)`` takes the noise
and the augment draws from the caller, so a test can replay another run.
Snapshots use the JAX package's numpy layout (`runtime.checkpoint`): G,
D and G_ema as flax trees, and optax's Adam states. ``stem_variables``
(the superres phase's stem decoder) and ``encoder_variables`` (a
pretrained ReStyle encoder) merge into G by name and shape through
`models.sg3.superres.reinit_stem`; `carried` lists what each took.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.sg3.config import SG3Config
from ..models.sg3.from_jax import (adam_moments, load_jax_variables, optax_adam_state,
                                   to_jax_variables)
from ..models.sg3.superres import matching_leaves, reinit_stem
from ..runtime.checkpoint import load_pytree, save_pytree
from ..runtime.profiling import drain_scope_times, profiled_scope
from ..runtime.training_stats import StatsCollector
from .ada import AdaController, AdaState
from .discriminator import ProjectedSetDiscriminator, projector_param_mask
from .loss import SetGANLossConfig, blur_images, blur_sigma_at, d_main_loss, g_main_loss
from .model import SetGAN

ADAM_EPS = 1e-8  # optax.adam's default
PATH_LENGTH_ITEM = ("path-length regularisation: a double-differentiable device.conv2d "
                    "backward and a backward for #2 (ROADMAP Queue 1)")


@dataclasses.dataclass
class SetGANTrainConfig:
    total_kimg: float = 10000
    batch_size: int = 8  # candidate sets per step
    g_lr: float = 0.0025
    d_lr: float = 0.002
    beta2: float = 0.99
    ema_kimg: float = 10.0
    # EMA ramp-up: early in training the EMA horizon is capped at
    # cur_nimg · ema_rampup; None disables it (as on --resume).
    ema_rampup: Optional[float] = 0.05
    # Batches the input thread keeps assembled and on the card ahead of the
    # step; 0 places them inline.
    prefetch_batches: int = 2
    warmup_kimg: float = 0.0
    g_reg_interval: int = 4
    tick_kimg: float = 4.0
    snapshot_ticks: int = 50
    eval_ticks: int = 50
    seed: int = 0
    # ADA: None keeps D's unconditional DiffAugment; a target gates it with
    # a probability p that the host adapts from the real logits' signs.
    ada_target: Optional[float] = None
    ada_interval_imgs: int = 256
    ada_kimg: float = 500.0
    augment_p: float = 0.0
    # The projected discriminator's feature backbones.
    d_backbones: tuple = ("deit_base_distilled_patch16_224", "tf_efficientnet_lite0")
    stem: str = "sg3"
    # The encoder's reference resolution.
    ref_resolution: int = 256
    # None → `resolution < 224`; ViT backbones are resized to 224 either way.
    d_interp224: Optional[bool] = None
    d_latent_size: int = 512
    d_num_discs: int = 4
    # Recompute the frozen D trunks / the reference encoder in the backward
    # instead of keeping their activations.
    d_remat_features: bool = False
    g_remat_encoder: bool = False
    # The superres phase: only the decoder's head layers train.
    train_head_only: bool = False
    head_layer_names: tuple = ()
    # The pretrained phase: the encoder and the decoder stay fixed.
    freeze_encoder: bool = False
    freeze_decoder: bool = False
    restyle_mode: str = "none"  # 'none' | 'encoder'
    restyle_iters: int = 3
    g_attn_heads: int = 4
    g_attn_layers: int = 2
    d_attn_heads: int = 4
    d_attn_layers: int = 2
    use_set_decoder: bool = True
    use_temperature: bool = False
    disable_style_concat: bool = False
    mean_center: Optional[bool] = None  # None → off only for the fastgan stem
    encoder_type: str = "ProgressiveBackboneEncoder"
    encoder_num_layers: int = 50
    loss: SetGANLossConfig = dataclasses.field(default_factory=SetGANLossConfig)


def _scrubbed(params: List[torch.Tensor], grads) -> List[torch.Tensor]:
    """Gradients with NaN → 0 and ±inf → the largest finite value (``nan_to_num``);
    zeros where a parameter got none, which Adam steps as optax does."""
    return [torch.zeros_like(p) if g is None else torch.nan_to_num(g)
            for p, g in zip(params, grads)]


@contextmanager
def _not_differentiated(module: torch.nn.Module):
    """``module``'s parameters take no gradient inside the block."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


class SetGANTrainer:
    """Builds G, D and G_ema on the card (or ``device="cpu"``), steps them
    and runs the tick loop."""

    def __init__(self, cfg: SetGANTrainConfig, decoder_cfg: SG3Config,
                 run_dir: Optional[str] = None, generator_variables: Optional[dict] = None,
                 stem_variables: Optional[dict] = None,
                 encoder_variables: Optional[dict] = None, device: DeviceLike = None):
        if cfg.loss.pl_weight > 0:
            raise NotImplementedError(f"loss.pl_weight > 0 needs {PATH_LENGTH_ITEM}")
        self.device = resolve_device(device)
        self.cfg, self.decoder_cfg = cfg, decoder_cfg
        self.run_dir = Path(run_dir) if run_dir else None
        self.stats = StatsCollector()
        self.cur_nimg = self.cur_tick = 0
        self.best_fid: Optional[float] = None
        self._pending: List[Dict[str, torch.Tensor]] = []

        mean_center = cfg.mean_center if cfg.mean_center is not None else cfg.stem != "fastgan"
        self.G = SetGAN(decoder_cfg, stem=cfg.stem, n_heads=cfg.g_attn_heads,
                        attn_layers=cfg.g_attn_layers, mean_center=mean_center,
                        use_set_decoder=cfg.use_set_decoder,
                        use_temperature=cfg.use_temperature,
                        disable_style_concat=cfg.disable_style_concat,
                        restyle_mode=cfg.restyle_mode, restyle_iters=cfg.restyle_iters,
                        encoder_type=cfg.encoder_type,
                        encoder_num_layers=cfg.encoder_num_layers,
                        remat_encoder=cfg.g_remat_encoder, ref_resolution=cfg.ref_resolution,
                        device=self.device,
                        generator=torch.Generator().manual_seed(cfg.seed)).eval()
        if generator_variables is not None:
            load_jax_variables(self.G.decoder, generator_variables)
        # Pretrained weights merge by name and shape (`reinit_stem`): a grown
        # decoder takes what matches of its stem, the encoder what matches of
        # a ReStyle encoder (a 6-channel first conv skips in a 3-channel one).
        self.carried: Dict[str, List[str]] = {}
        for part, variables in (("decoder", stem_variables), ("encoder", encoder_variables)):
            if variables is not None:
                module = getattr(self.G, part)
                tree = to_jax_variables(module)
                self.carried[part] = matching_leaves(tree, variables)
                load_jax_variables(module, reinit_stem(tree, variables))
        interp224 = cfg.d_interp224 if cfg.d_interp224 is not None \
            else decoder_cfg.img_resolution < 224
        self.D = ProjectedSetDiscriminator(
            decoder_cfg.img_resolution, latent_size=cfg.d_latent_size,
            num_discs=cfg.d_num_discs, interp224=interp224, backbones=tuple(cfg.d_backbones),
            attn_heads=cfg.d_attn_heads, attn_layers=cfg.d_attn_layers,
            remat_features=cfg.d_remat_features, device=self.device,
            generator=torch.Generator().manual_seed(cfg.seed + 1)).eval()
        self.latent_avg = (self.G.decoder.mapping.w_avg.detach().clone() if cfg.stem != "fastgan"
                           else torch.zeros(decoder_cfg.w_dim, device=self.device))
        self.G_ema = copy.deepcopy(self.G).requires_grad_(False)
        self.pl_mean = torch.zeros((), device=self.device)

        # The groups that train; the rest keep requires_grad False for good.
        d_trains = set(projector_param_mask(self.D))
        self.g_params = {n: p for n, p in self.G.named_parameters() if self._g_trains(n)}
        self.d_params = {n: p for n, p in self.D.named_parameters() if n in d_trains}
        for module, trains in ((self.G, self.g_params), (self.D, self.d_params)):
            for n, p in module.named_parameters():
                p.requires_grad_(n in trains)
        betas = (0.0, cfg.beta2)
        self.g_opt = torch.optim.Adam(list(self.g_params.values()), lr=cfg.g_lr, betas=betas,
                                      eps=ADAM_EPS)
        self.d_opt = torch.optim.Adam(list(self.d_params.values()), lr=cfg.d_lr, betas=betas,
                                      eps=ADAM_EPS)
        self.g_steps = self.d_steps = 0

        self.ada: Optional[AdaController] = None
        if cfg.ada_target is not None:
            self.ada = AdaController(target=cfg.ada_target, interval_imgs=cfg.ada_interval_imgs,
                                     ada_kimg=cfg.ada_kimg)
            self.ada.state.p = float(cfg.augment_p)
        self._z_gen = torch.Generator(self.device).manual_seed(cfg.seed + 2)
        self._aug_gen = torch.Generator(self.device).manual_seed(cfg.seed + 3)

    def _g_trains(self, name: str) -> bool:
        cfg = self.cfg
        top, _, rest = name.partition(".")
        if top == "encoder":
            return not cfg.freeze_encoder
        if top == "decoder":
            if cfg.freeze_decoder:
                return False
            if cfg.train_head_only:
                sub, _, layer = rest.partition(".")
                if sub == "mapping":
                    return False
                if sub == "synthesis":
                    return layer.split(".")[0] in set(cfg.head_layer_names)
        return True

    # ------------------------------------------------------------ the steps

    def g_lr_at(self, step: int) -> float:
        """G's rate at optimizer step ``step`` (from 0): the linear warm-up."""
        cfg = self.cfg
        if cfg.warmup_kimg <= 0:
            return cfg.g_lr
        warm_steps = cfg.warmup_kimg * 1000 / max(cfg.batch_size, 1)
        return cfg.g_lr * min((step + 1) / warm_steps, 1.0)

    def _run_g(self, G, batch, z, force_fp32: bool = False, impl: str = "auto"):
        # The encoder runs in eval mode: its batch norms keep their statistics.
        return G(batch["reference"], z, latent_avg=self.latent_avg, ref_mask=batch["ref_mask"],
                 return_latents=True, train=False, force_fp32=force_fp32, impl=impl)

    def _ada_p(self):
        return None if self.ada is None else self.ada.state.p

    def d_loss_and_grads(self, batch, z, draws, blur_sigma: float, force_fp32: bool = False,
                         impl: str = "auto"):
        """The D step's loss, statistics and gradients (scrubbed), by parameter name."""
        with torch.no_grad():
            gen_imgs, _ = self._run_g(self.G, batch, z, force_fp32, impl)
        gen_b = blur_images(gen_imgs, blur_sigma)
        real_b = blur_images(batch["candidate"], blur_sigma)
        kw = dict(r_mask=batch["ref_mask"], x_mask=batch["cand_mask"], ada_p=self._ada_p())
        fake_logits = self.D(batch["reference"], gen_b, draws=draws["fake"], **kw)
        real_logits = self.D(batch["reference"], real_b, draws=draws["real"], **kw)
        loss, stats = d_main_loss(real_logits, fake_logits)
        params = list(self.d_params.values())
        with profiled_scope("backward"):
            grads = _scrubbed(params, torch.autograd.grad(loss, params, allow_unused=True))
        return loss.detach(), {k: v.detach() for k, v in stats.items()}, \
            dict(zip(self.d_params, grads))

    def g_loss_and_grads(self, batch, z, draws, blur_sigma: float, force_fp32: bool = False,
                         impl: str = "auto"):
        """The G step's loss, statistics and gradients (scrubbed), by parameter name."""
        with _not_differentiated(self.D):
            imgs, _ = self._run_g(self.G, batch, z, force_fp32, impl)
            logits = self.D(batch["reference"], blur_images(imgs, blur_sigma), draws=draws["g"],
                            r_mask=batch["ref_mask"], x_mask=batch["cand_mask"],
                            ada_p=self._ada_p())
            loss = g_main_loss(logits)
        params = list(self.g_params.values())
        with profiled_scope("backward"):
            grads = _scrubbed(params, torch.autograd.grad(loss, params, allow_unused=True))
        stats = {"Loss/G/loss": loss.detach(), "Loss/scores/fake_G": logits.detach().mean()}
        return loss.detach(), stats, dict(zip(self.g_params, grads))

    @staticmethod
    def _adam_step(opt: torch.optim.Optimizer, params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], lr: float) -> None:
        for group in opt.param_groups:
            group["lr"] = lr
        for name, p in params.items():
            p.grad = grads[name]
        with profiled_scope("adam"):
            opt.step()
        for p in params.values():
            p.grad = None

    def _place(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k in ("reference", "ref_mask", "candidate", "cand_mask"):
            v = batch[k]
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            out[k] = v.to(self.device, non_blocking=True)
        return out

    def draw(self, batch_size: int, num_candidates: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """The augment draws of one step: the D step's fake and real passes
        and the G step's, each over ``batch_size · num_candidates`` images."""
        n = batch_size * num_candidates
        return {k: self.D.draw(n, self._aug_gen) for k in ("fake", "real", "g")}

    def train_step(self, batch, impl: str = "auto", z: Optional[torch.Tensor] = None,
                   draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """One D and one G step, then G_ema. ``batch``: ``reference``
        ``[B, R, H, W, 3]``, ``ref_mask`` ``[B, R]``, ``candidate``
        ``[B, C, res, res, 3]``, ``cand_mask`` ``[B, C]`` (numpy or tensors);
        ``z`` ``[B, C, z_dim]`` and ``draws`` (as `draw` gives them) are drawn
        from the trainer's generators unless given. Returns the step's
        metrics as 0-d tensors on the device."""
        cfg = self.cfg
        placed = self._place(batch)
        b, c_max = placed["candidate"].shape[:2]
        if z is None:
            z = torch.randn((b, c_max, self.decoder_cfg.z_dim), generator=self._z_gen,
                            device=self.device)
        if draws is None:
            draws = self.draw(b, c_max)
        # σ in steps of 0.1, as the JAX package quantises it for its compiles.
        blur_sigma = float(np.round(blur_sigma_at(self.cur_nimg, cfg.loss), 1))
        with profiled_scope("Dmain"):
            _, d_stats, d_grads = self.d_loss_and_grads(placed, z, draws, blur_sigma, impl=impl)
            self._adam_step(self.d_opt, self.d_params, d_grads, cfg.d_lr)
            self.d_steps += 1
        with profiled_scope("Gmain"):
            _, g_stats, g_grads = self.g_loss_and_grads(placed, z, draws, blur_sigma, impl=impl)
            self._adam_step(self.g_opt, self.g_params, g_grads, self.g_lr_at(self.g_steps))
            self.g_steps += 1
        del d_grads, g_grads
        self._update_ema()
        self.cur_nimg += cfg.batch_size
        metrics = {**d_stats, **g_stats}
        if self.ada is not None:
            c_eff = int(placed["cand_mask"].sum())
            metrics["Progress/augment"] = torch.tensor(
                self.ada.update(float(d_stats["Loss/signs/real"]), c_eff))
        self._pending.append(metrics)
        return metrics

    @torch.no_grad()
    def _update_ema(self) -> None:
        cfg = self.cfg
        ema_nimg = cfg.ema_kimg * 1000
        if cfg.ema_rampup is not None:
            ema_nimg = min(ema_nimg, self.cur_nimg * cfg.ema_rampup)
        beta = 0.5 ** (cfg.batch_size / max(ema_nimg, 1e-8))
        ema = list(self.G_ema.parameters())
        params = [p.detach() for p in self.G.parameters()]
        with profiled_scope("ema"):  # p + β·(e − p), the JAX package's arithmetic
            torch._foreach_sub_(ema, params)
            torch._foreach_mul_(ema, beta)
            torch._foreach_add_(ema, params)

    def _drain_metrics(self) -> None:
        """Move the pending metrics to the host (one copy) into `stats`."""
        if not self._pending:
            return
        names = sorted(self._pending[0])
        rows = torch.stack([torch.stack([m[k].float().to(self.device) for k in names])
                            for m in self._pending]).cpu().numpy()
        for row in rows:
            self.stats.update(dict(zip(names, row)))
        self._pending.clear()

    # ------------------------------------------------------------ inference

    @torch.no_grad()
    def generate(self, references, num_candidates: int, use_ema: bool = True, seed: int = 0,
                 z: Optional[torch.Tensor] = None) -> np.ndarray:
        """Candidates ``[B, num_candidates, res, res, 3]`` for reference sets
        ``[B, R, H, W, 3]`` in [−1, 1], from G_ema (or G); ``z`` drawn from
        ``seed`` unless given."""
        refs = torch.as_tensor(np.asarray(references) if not isinstance(references, torch.Tensor)
                               else references).to(self.device)
        b = refs.shape[0]
        if z is None:
            z = torch.randn((b, num_candidates, self.decoder_cfg.z_dim),
                            generator=torch.Generator().manual_seed(seed))
        batch = {"reference": refs,
                 "ref_mask": torch.ones(refs.shape[:2], dtype=torch.bool, device=self.device)}
        imgs, _ = self._run_g(self.G_ema if use_ema else self.G, batch, z.to(self.device))
        return imgs.float().cpu().numpy()

    # ------------------------------------------------------------ the loop

    def train(self, data: Iterable, total_kimg: Optional[float] = None,
              eval_fn: Optional[Callable[["SetGANTrainer"], float]] = None,
              log_fn: Optional[Callable[[dict], None]] = None) -> "SetGANTrainer":
        """Step over ``data`` (batches of numpy arrays) until ``total_kimg``:
        each tick prints and logs the statistics (``stats.jsonl``, events),
        runs ``eval_fn`` every ``eval_ticks`` (the best one snapshots
        ``best_model``), and every ``snapshot_ticks`` a snapshot and a grid
        of fakes."""
        from ..data.prefetch import DevicePrefetcher, maybe_prefetch

        cfg = self.cfg
        total_nimg = (total_kimg or cfg.total_kimg) * 1000
        writer = None
        if self.run_dir:
            from ..runtime.events import EventWriter, module_summary
            self.run_dir.mkdir(parents=True, exist_ok=True)
            writer = EventWriter(self.run_dir)
            for name, module in (("G", self.G), ("D", self.D)):
                text = f"=== {name} ===\n{module_summary(module)}"
                print(text)
                with open(self.run_dir / "module_summary.txt", "a") as f:
                    f.write(text + "\n")

        def place(batch):
            return {"_host_reference": np.asarray(batch["reference"][:4]), **self._place(batch)}

        it = maybe_prefetch(iter(data), place, cfg.prefetch_batches)
        try:
            self._train_loop(it, total_nimg, writer, eval_fn, log_fn)
        finally:
            if isinstance(it, DevicePrefetcher):
                it.close()
            if writer is not None:
                writer.close()
        return self

    def _train_loop(self, it, total_nimg, writer, eval_fn, log_fn) -> None:
        cfg = self.cfg
        tick_nimg = cfg.tick_kimg * 1000
        next_tick = tick_nimg
        t_start = t_tick = time.time()
        grid_refs = None
        for batch in it:
            if grid_refs is None:  # fixed reference sets for the sample grids
                grid_refs = batch["_host_reference"]
            self.train_step(batch)
            if self.cur_nimg >= next_tick or self.cur_nimg >= total_nimg:
                self._drain_metrics()
                now = time.time()
                entry = {
                    "tick": self.cur_tick,
                    "kimg": self.cur_nimg / 1000,
                    "sec_per_tick": round(now - t_tick, 2),
                    "sec_per_kimg": round((now - t_tick) / max(tick_nimg / 1000, 1e-8), 2),
                    "total_hours": round((now - t_start) / 3600, 3),
                    **{f"Timing/{k}": round(v, 4) for k, v in drain_scope_times().items()},
                    **{k: round(self.stats.mean(k), 4) for k in self.stats.names()},
                }
                print(json.dumps(entry))
                if log_fn:
                    log_fn(entry)
                if self.run_dir:
                    with open(self.run_dir / "stats.jsonl", "a") as f:
                        f.write(json.dumps(entry) + "\n")
                self.stats.reset()
                if eval_fn and self.cur_tick % cfg.eval_ticks == 0 and self.cur_tick > 0:
                    fid = eval_fn(self)
                    print(json.dumps({"tick": self.cur_tick, "fid": fid}))
                    if self.best_fid is None or fid < self.best_fid:
                        self.best_fid = fid
                        if self.run_dir:
                            self.snapshot(self.run_dir / "best_model")
                if writer is not None:
                    writer.scalars(entry, step=self.cur_nimg)
                if self.run_dir and self.cur_tick % cfg.snapshot_ticks == 0:
                    self.snapshot(self.run_dir / f"snapshot_{self.cur_nimg // 1000:06d}")
                    from ..runtime.events import save_image_grid
                    fakes = self.generate(grid_refs, num_candidates=4)
                    grid = save_image_grid(fakes.reshape((-1,) + fakes.shape[2:]),
                                           self.run_dir / f"fakes_{self.cur_nimg // 1000:06d}.png",
                                           cols=4)
                    if writer is not None:
                        writer.image("fakes", grid, step=self.cur_nimg)
                self.cur_tick += 1
                t_tick = time.time()
                next_tick += tick_nimg
            if self.cur_nimg >= total_nimg:
                break

    # ------------------------------------------------------------ snapshots

    def _opt_trees(self):
        trees = []
        cfg = self.cfg
        g_masked = cfg.train_head_only or cfg.freeze_encoder or cfg.freeze_decoder
        for opt, module, params, steps, schedule, masked in (
                (self.g_opt, self.G, self.g_params, self.g_steps, True, g_masked),
                (self.d_opt, self.D, self.d_params, self.d_steps, False, True)):
            mu, nu = {}, {}
            for name, p in params.items():
                state = opt.state.get(p, {})
                for out, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                    out[name] = (state[key] if state else torch.zeros_like(p)).detach().cpu().numpy()
            names = [n for n, _ in module.named_parameters()]
            trees.append(optax_adam_state(steps, mu, nu, names, schedule, masked))
        return trees

    def snapshot(self, path) -> None:
        """Write G, D, G_ema and both Adam states in the JAX package's layout
        (``g_vars``, ``d_vars``, ``g_ema_params``, ``g_opt``, ``d_opt``,
        ``pl_mean``) with the progress counters in the sidecar."""
        g_opt, d_opt = self._opt_trees()
        tree = {"g_vars": to_jax_variables(self.G), "d_vars": to_jax_variables(self.D),
                "g_ema_params": to_jax_variables(self.G_ema)["params"],
                "g_opt": g_opt, "d_opt": d_opt, "pl_mean": self.pl_mean}
        meta = {"cur_nimg": self.cur_nimg, "cur_tick": self.cur_tick, "best_fid": self.best_fid,
                "cfg": dataclasses.asdict(self.cfg),
                "decoder_cfg": dataclasses.asdict(self.decoder_cfg)}
        if self.ada is not None:
            meta["ada"] = dataclasses.asdict(self.ada.state)
        save_pytree(path, tree, meta)

    def restore(self, path) -> "SetGANTrainer":
        """Load a snapshot written by `snapshot` or by the JAX package's trainer."""
        tree, meta = load_pytree(path)
        load_jax_variables(self.G, tree["g_vars"])
        load_jax_variables(self.D, tree["d_vars"])
        load_jax_variables(self.G_ema, {**tree["g_vars"], "params": tree["g_ema_params"]})
        for key, opt, params, attr in (("g_opt", self.g_opt, self.g_params, "g_steps"),
                                       ("d_opt", self.d_opt, self.d_params, "d_steps")):
            count, mu, nu = adam_moments(tree[key])
            if set(mu) != set(params):
                raise KeyError(f"{key}: the snapshot's Adam moments are for other parameters "
                               f"({sorted(set(mu) ^ set(params))[:4]}…)")
            opt.state.clear()
            if count:
                for name, p in params.items():
                    opt.state[p] = {
                        "step": torch.tensor(float(count)),
                        "exp_avg": torch.as_tensor(mu[name], dtype=p.dtype).to(p.device).clone(),
                        "exp_avg_sq": torch.as_tensor(nu[name], dtype=p.dtype).to(p.device).clone()}
            setattr(self, attr, count)
        self.pl_mean = torch.as_tensor(np.asarray(tree["pl_mean"]), dtype=torch.float32).to(
            self.device)
        if meta:
            self.cur_nimg = int(meta["cur_nimg"])
            self.cur_tick = int(meta["cur_tick"])
            self.best_fid = meta.get("best_fid")
            if self.ada is not None and meta.get("ada"):
                self.ada.state = AdaState(**meta["ada"])
        return self
