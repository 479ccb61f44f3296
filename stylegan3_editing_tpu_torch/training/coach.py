"""ReStyle pSp / e4e coach: the encoder training loop on the card.

Counterpart of the JAX package's `training/coach.py` (reference
coach_restyle_psp.py: the ReStyle iterations :91-112, gradient accumulation
:128-130, validation and the best checkpoint :140-205; coach_restyle_e4e.py:
the latent discriminator :340-349, :462-494, the delta loss :351-362, the
progressive stages :431-436, the W pool :506-519), step for step:

- one micro-step runs every ReStyle iteration and differentiates the sum of
  their losses. As in the JAX package the image and latent of iteration k
  feed iteration k + 1 with their graphs (no detach), so the gradient runs
  back through every decode and every encoder pass; the encoder runs with
  ``train=True``, its batch-norm statistics chaining across the iterations;
- gradients accumulate as ``optax.MultiSteps`` does: Welford's mean
  ``acc + (g − acc)/(n + 1)``, and every k-th micro-step (k = effective
  batch / batch) the optimizer (Ranger or Adam) steps on ``acc``, its clock
  advancing only then; the accumulator and its count are checkpointed;
- the e4e discriminator steps before the G step of every micro-step (Adam on
  the non-saturating loss, then R1 every ``d_reg_every`` steps, a gradient of
  a gradient), fed by the two replay pools (seed 0); the G step's
  adversarial term reads the updated discriminator;
- the decoder and the loss networks (LPIPS-alex, the ID loss's IR-SE-50,
  MoCo's ResNet-50) are frozen (``requires_grad_(False)``) unless
  ``train_decoder``, so the filtered-lrelu backward kernel computes dx only;
  the loss networks are seeded, not loaded, unless ``loss_variables`` are
  given. The ID and MoCo losses embed ``x`` and ``y`` once a micro-step and
  ŷ once an iteration (the same losses as their per-iteration form).

Checkpoints are written in the JAX package's layout (``variables`` as the
flax tree and ``latent_avg``; ``opts``, ``global_step``, ``best_val_loss``
and ``is_e4e`` in the sidecar), so both packages' ``load_encoder`` read
them; the optimizers', the accumulator's (mid-accumulation only: it is zero
at a cycle's end) and the discriminator's states go under the port's own
keys, which `restore` reads.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..criteria import IDLoss, LPIPS, MocoLoss, w_norm_loss
from ..device import DeviceLike, resolve_device
from ..models.encoders import RestyleNet
from ..models.encoders.backbones import INFERENCE_STAGE
from ..models.sg3 import SG3Config, load_jax_variables, sg3_r_config, to_jax_variables
from ..runtime.checkpoint import load_pytree, save_pytree
from ..runtime.training_stats import StatsCollector
from .latent_discriminator import LatentCodesDiscriminator, LatentCodesPool
from .options import E4eTrainOptions, TrainOptions
from .ranger import ranger

Named = List[Tuple[str, nn.Parameter]]


def _optimizer_tree(optimizer: torch.optim.Optimizer, named: Named) -> dict:
    """An optimizer's state by parameter name, and each group's step."""
    names = {id(p): name for name, p in named}
    return {"group_step": [np.asarray(g.get("step", 0), np.int64) for g in optimizer.param_groups],
            "state": {names[id(p)]: dict(s) for p, s in optimizer.state.items()}}


def _load_optimizer(optimizer: torch.optim.Optimizer, named: Named, tree: dict) -> None:
    for group, step in zip(optimizer.param_groups, tree["group_step"]):
        if int(step):  # Ranger's clock; Adam keeps its steps per tensor
            group["step"] = int(step)
    optimizer.state.clear()
    for name, p in named:
        if name in tree["state"]:
            # Adam keeps its per-tensor 'step' on the host.
            optimizer.state[p] = {k: torch.as_tensor(np.asarray(v)).to(
                "cpu" if k == "step" else p.device) for k, v in tree["state"][name].items()}


class Coach:
    """Trains a ReStyle encoder against an alias-free decoder.

    ``decoder_variables`` (``{params, buffers, ema}`` of a generator) fill
    the decoder; ``loss_variables`` (``{"lpips" | "id" | "moco": flax
    tree}``) the loss networks, which are seeded otherwise. Built on the CUDA
    card unless ``device="cpu"``.
    """

    def __init__(self, opts: TrainOptions, decoder_cfg: Optional[SG3Config] = None,
                 decoder_variables: Optional[dict] = None,
                 loss_variables: Optional[Dict[str, dict]] = None, device: DeviceLike = None):
        self.device = device = resolve_device(device)
        self.opts = opts
        self.is_e4e = isinstance(opts, E4eTrainOptions)
        self.global_step = 0
        self.best_val_loss: Optional[float] = None
        self.stats = StatsCollector()

        self.decoder_cfg = decoder_cfg or sg3_r_config(opts.output_size)
        self.n_styles = self.decoder_cfg.num_ws
        self.model = RestyleNet(self.decoder_cfg, encoder_type=opts.encoder_type,
                                n_styles=self.n_styles, input_nc=opts.input_nc, device=device,
                                generator=torch.Generator().manual_seed(opts.seed))
        if decoder_variables is not None:
            load_jax_variables(self.model.decoder, decoder_variables)
        self.model.decoder.requires_grad_(bool(opts.train_decoder))

        # Loss networks (frozen), seeded as the JAX coach's PRNG keys 1-3 number them.
        self.lpips = LPIPS("alex", device, torch.Generator().manual_seed(1)) \
            if opts.lpips_lambda > 0 else None
        self.id_loss = IDLoss(device=device, generator=torch.Generator().manual_seed(2)) \
            if opts.id_lambda > 0 else None
        self.moco_loss = MocoLoss(device, torch.Generator().manual_seed(3)) \
            if opts.moco_lambda > 0 else None
        for net in self.loss_nets().values():
            net.requires_grad_(False)

        self.trainable: Named = [(n, p) for n, p in self.model.named_parameters()
                                 if n.startswith("encoder.") or opts.train_decoder]
        params = [p for _, p in self.trainable]
        self.optimizer = (ranger(params, opts.learning_rate) if opts.optim_name == "ranger"
                          else torch.optim.Adam(params, opts.learning_rate))
        self.accum_steps = max(int(opts.effective_batch_size / opts.batch_size), 1)
        self.accum = [torch.zeros_like(p) for p in params]
        self.accum_count = 0

        self.disc = None
        if self.is_e4e and opts.w_discriminator_lambda > 0:
            self.disc = LatentCodesDiscriminator(self.decoder_cfg.w_dim, 4,
                                                 torch.Generator().manual_seed(4)).to(device)
            self.disc_optimizer = torch.optim.Adam(self.disc.parameters(),
                                                   opts.w_discriminator_lr)
            self.real_w_pool = LatentCodesPool(opts.w_pool_size)
            self.fake_w_pool = LatentCodesPool(opts.w_pool_size)
        self._z_generator = torch.Generator().manual_seed(opts.seed)

        self.load_jax_state(loss_variables=loss_variables)

    # ------------------------------------------------------------- helpers

    def loss_nets(self) -> Dict[str, nn.Module]:
        return {k: v for k, v in (("lpips", self.lpips), ("id", self.id_loss),
                                  ("moco", self.moco_loss)) if v is not None}

    def load_jax_state(self, variables: Optional[dict] = None, latent_avg=None,
                       disc_variables: Optional[dict] = None,
                       loss_variables: Optional[Dict[str, dict]] = None) -> "Coach":
        """Carry a JAX coach's state in: its RestyleNet ``variables``, its
        ``latent_avg`` (the decoder's ``w_avg`` when not given), its
        discriminator's and its loss networks' variables. Recomputes the
        average image."""
        if variables is not None:
            load_jax_variables(self.model, variables)
        for name, v in (loss_variables or {}).items():
            load_jax_variables(self.loss_nets()[name], v)
        if disc_variables is not None:
            load_jax_variables(self.disc, disc_variables)
        avg = self.model.decoder.mapping.w_avg if latent_avg is None else latent_avg
        self.latent_avg = (avg.detach().float().clone() if isinstance(avg, torch.Tensor)
                           else self._tensor(np.asarray(avg)))
        self.avg_image = self._compute_avg_image()
        return self

    def _compute_avg_image(self, impl: str = "auto") -> torch.Tensor:
        codes = self.latent_avg[None, None, :].expand(1, self.n_styles, self.decoder_cfg.w_dim)
        with torch.no_grad():
            img, _ = self.model(codes, input_code=True, impl=impl)
        return img[0]

    def _current_stage(self) -> int:
        if not (self.is_e4e and self.opts.progressive_steps):
            return INFERENCE_STAGE
        stage = 0
        for i, step in enumerate(self.opts.progressive_steps):
            if self.global_step >= step:
                stage = i
        return min(stage, self.n_styles - 1)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    @staticmethod
    def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Metric tensors → floats, with one device sync."""
        values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()])
        return dict(zip(metrics, values.tolist()))

    # ---------------------------------------------------------- loss logic

    def _restyle_forward(self, x: torch.Tensor, train: bool, stage: int, impl: str = "auto"
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Every ReStyle iteration; per iteration (y_hat, latent), each feeding
        the next with its graph."""
        n = x.shape[0]
        y_hat = self.avg_image[None].expand((n,) + tuple(self.avg_image.shape))
        latent = None
        outputs = []
        for _ in range(self.opts.n_iters_per_batch):
            x_input = torch.cat([x, y_hat], dim=-1)
            y_hat, latent = self.model(x_input, latent=latent, latent_avg=self.latent_avg,
                                       train=train, stage=stage,
                                       force_fp32=self.opts.force_fp32_decoder, impl=impl)
            outputs.append((y_hat, latent))
        return outputs

    def _target_feats(self, x: torch.Tensor, y: torch.Tensor) -> Dict[str, tuple]:
        """The ID and MoCo embeddings of x and y (no graph: neither depends on
        a trained weight, and the target's is detached in the losses)."""
        with torch.no_grad():
            return {name: (net.extract_feats(x), net.extract_feats(y))
                    for name, net in (("id", self.id_loss), ("moco", self.moco_loss))
                    if net is not None}

    @staticmethod
    def _similarity_loss(net: nn.Module, y_hat: torch.Tensor, feats: tuple):
        """`IDLoss` / `MocoLoss`'s (loss, sim_improvement) from the embeddings
        of x and y."""
        x_feats, y_feats = feats
        diff_target = (net.extract_feats(y_hat) * y_feats).sum(-1)
        diff_views = (y_feats * x_feats).sum(-1)
        return (1 - diff_target).mean(), (diff_target - diff_views).mean()

    def _calc_loss(self, y: torch.Tensor, y_hat: torch.Tensor, latent: torch.Tensor,
                   stage: int, feats: Dict[str, tuple]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The λ-weighted loss of one ReStyle iteration, in the JAX coach's order."""
        opts = self.opts
        loss = torch.zeros((), dtype=torch.float32, device=y.device)
        metrics: Dict[str, torch.Tensor] = {}
        staged = stage != INFERENCE_STAGE
        if self.disc is not None:
            dims = min(stage + 1, self.n_styles) if staged else self.n_styles
            fake_pred = self.disc(latent[:, :dims].reshape(-1, latent.shape[-1]))
            loss_disc = F.softplus(-fake_pred).mean()
            metrics["encoder_discriminator_loss"] = loss_disc
            loss = loss + opts.w_discriminator_lambda * loss_disc
        if staged:
            first_w = latent[:, 0, :]
            total_delta = torch.zeros((), dtype=torch.float32, device=y.device)
            for i in range(1, min(stage + 1, self.n_styles)):
                delta = latent[:, i, :] - first_w
                total_delta = total_delta + torch.linalg.vector_norm(
                    delta, ord=opts.delta_norm, dim=1).mean()
            metrics["total_delta_loss"] = total_delta
            loss = loss + opts.delta_norm_lambda * total_delta
        if opts.id_lambda > 0:
            loss_id, sim = self._similarity_loss(self.id_loss, y_hat, feats["id"])
            metrics["loss_id"] = loss_id
            metrics["id_improve"] = sim
            loss = loss + loss_id * opts.id_lambda
        if opts.l2_lambda > 0:
            loss_l2 = (y_hat - y).square().mean()
            metrics["loss_l2"] = loss_l2
            loss = loss + loss_l2 * opts.l2_lambda
        if opts.lpips_lambda > 0:
            loss_lpips = self.lpips(y_hat, y)
            metrics["loss_lpips"] = loss_lpips
            loss = loss + loss_lpips * opts.lpips_lambda
        if opts.w_norm_lambda > 0:
            loss_w = w_norm_loss(latent, self.latent_avg, opts.start_from_latent_avg)
            metrics["loss_w_norm"] = loss_w
            loss = loss + loss_w * opts.w_norm_lambda
        if opts.moco_lambda > 0:
            loss_moco, sim = self._similarity_loss(self.moco_loss, y_hat, feats["moco"])
            metrics["loss_moco"] = loss_moco
            metrics["id_improve"] = sim
            loss = loss + loss_moco * opts.moco_lambda
        metrics["loss"] = loss
        return loss, metrics

    def _loss_and_grads(self, x: torch.Tensor, y: torch.Tensor, stage: int, impl: str
                        ) -> Tuple[Dict[str, torch.Tensor], Sequence[Optional[torch.Tensor]]]:
        """The summed loss of every iteration (the last iteration's metrics
        and ``loss_total``, keys sorted as the JAX step returns them) and the
        trainable parameters' gradients (None where the loss does not reach)."""
        outputs = self._restyle_forward(x, train=True, stage=stage, impl=impl)
        feats = self._target_feats(x, y)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        metrics: Dict[str, torch.Tensor] = {}
        for y_hat, latent in outputs:
            loss, metrics = self._calc_loss(y, y_hat, latent, stage, feats)
            total = total + loss
        metrics["loss_total"] = total
        grads = torch.autograd.grad(total, [p for _, p in self.trainable], allow_unused=True)
        return dict(sorted(metrics.items())), grads

    def _apply_gradients(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """optax.MultiSteps: the Welford mean of the micro-steps' gradients;
        the optimizer steps on it every `accum_steps`-th micro-step."""
        n = self.accum_count
        with torch.no_grad():
            for acc, g in zip(self.accum, grads):
                g = torch.zeros_like(acc) if g is None else g
                acc.copy_(acc + (g - acc) / (n + 1))
        if n < self.accum_steps - 1:
            self.accum_count = n + 1
            return
        for (_, p), acc in zip(self.trainable, self.accum):
            p.grad = acc
        self.optimizer.step()
        for (_, p), acc in zip(self.trainable, self.accum):
            p.grad = None
            acc.zero_()
        self.accum_count = 0

    # ------------------------------------------------- discriminator steps

    def _sample_real_fake_w(self, x: torch.Tensor, z=None) -> Tuple[np.ndarray, np.ndarray]:
        """(real_w ``[N, num_ws, w]``, fake_w ``[N, n_styles, w]``) before
        pooling: real codes map ``z`` (drawn from the coach's generator when
        not given) at ``truncation_psi``; fake codes are the encoder's raw
        output in eval mode, no ``latent_avg`` residual (reference
        coach_restyle_e4e.py:510), a 6-channel encoder given the average
        image."""
        n = x.shape[0]
        if z is None:
            z = torch.randn((n, self.decoder_cfg.z_dim), generator=self._z_generator)
        with torch.no_grad():
            real_w = self.model.decoder.map(self._tensor(z),
                                            truncation_psi=self.opts.truncation_psi)
            if self.opts.input_nc == 6 and x.shape[-1] == 3:
                avg = self.avg_image[None].expand((n,) + tuple(self.avg_image.shape))
                x = torch.cat([x, avg], dim=-1)
            fake_w = self.model.encoder(x)
        return real_w.cpu().numpy(), fake_w.cpu().numpy()

    def train_discriminator(self, x: torch.Tensor, z=None) -> Dict[str, torch.Tensor]:
        """One D step with the pools and the periodic R1 (reference
        :462-494); the losses as tensors."""
        opts = self.opts
        real_w, fake_w = self._sample_real_fake_w(x, z)
        stage = self._current_stage()
        if stage != INFERENCE_STAGE:
            fake_w = fake_w[:, :min(stage + 1, self.n_styles), :]
        if opts.use_w_pool:
            real_w = self.real_w_pool.query(real_w)
            fake_w = self.fake_w_pool.query(fake_w)
        if fake_w.ndim == 3:
            fake_w = fake_w[:, 0, :]
        if real_w.ndim == 3:
            real_w = real_w[:, 0, :]
        real, fake = self._tensor(real_w), self._tensor(fake_w)

        self.disc_optimizer.zero_grad(set_to_none=True)
        real_loss = F.softplus(-self.disc(real)).mean()
        fake_loss = F.softplus(self.disc(fake)).mean()
        loss = real_loss + fake_loss
        loss.backward()
        self.disc_optimizer.step()
        out = {"discriminator_loss": loss.detach(), "d_real_loss": real_loss.detach(),
               "d_fake_loss": fake_loss.detach()}

        if self.global_step % opts.d_reg_every == 0:
            w = real.detach().requires_grad_(True)
            g, = torch.autograd.grad(self.disc(w).sum(), w, create_graph=True)
            pen = g.reshape(g.shape[0], -1).square().sum(dim=1).mean()
            r1_loss = opts.r1 / 2 * pen * opts.d_reg_every
            self.disc_optimizer.zero_grad(set_to_none=True)
            r1_loss.backward()
            # The output bias does not reach R1; its zero gradient still
            # steps Adam (its moments decay), as in optax.
            for p in self.disc.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.disc_optimizer.step()
            out["discriminator_r1_loss"] = r1_loss.detach()
        self.disc_optimizer.zero_grad(set_to_none=True)
        return out

    # ---------------------------------------------------------- public API

    def train_step(self, batch, impl: str = "auto", z=None) -> Dict[str, float]:
        """One micro-step: the D step (e4e), then the G step; the optimizer
        steps every `accum_steps`-th micro-step. ``z`` replaces the D step's
        draw of the real codes' latents."""
        x, y = self._tensor(batch[0]), self._tensor(batch[1])
        metrics: Dict[str, torch.Tensor] = {}
        if self.disc is not None:
            metrics.update(self.train_discriminator(x, z))
        m, grads = self._loss_and_grads(x, y, self._current_stage(), impl)
        self._apply_gradients(grads)
        metrics.update(m)
        out = self._floats(metrics)
        self.stats.update(out)
        self.global_step += 1
        return out

    def loss_and_grads(self, batch, impl: str = "auto"
                       ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
        """One G forward and backward without a D step or an update (the batch
        norms' statistics move as in a step): the metrics, and the
        gradients by parameter name (None where the loss does not reach)."""
        x, y = self._tensor(batch[0]), self._tensor(batch[1])
        m, grads = self._loss_and_grads(x, y, self._current_stage(), impl)
        return self._floats(m), {name: g for (name, _), g in zip(self.trainable, grads)}

    def validate(self, val_batches, impl: str = "auto") -> Dict[str, float]:
        """Mean metrics of the last iteration over ``val_batches``, the
        encoder on its running statistics."""
        stage = self._current_stage()
        agg = StatsCollector()
        with torch.no_grad():
            for batch in val_batches:
                x, y = self._tensor(batch[0]), self._tensor(batch[1])
                y_hat, latent = self._restyle_forward(x, train=False, stage=stage, impl=impl)[-1]
                _, m = self._calc_loss(y, y_hat, latent, stage, self._target_feats(x, y))
                agg.update(self._floats(dict(sorted(m.items()))))
        return {k: agg.mean(k) for k in agg.names()}

    def train(self, train_iter, val_batches_fn=None, max_steps: Optional[int] = None
              ) -> "Coach":
        """The outer loop: steps, ``stats.jsonl``, TensorBoard events, image
        grids, validation with the best checkpoint, interval checkpoints."""
        from ..data.prefetch import DevicePrefetcher, to_device
        from ..runtime.events import EventWriter, save_image_grid
        from ..runtime.profiling import drain_scope_times, profiled_scope

        opts = self.opts
        max_steps = max_steps or opts.max_steps
        start = time.time()
        exp_dir = Path(opts.exp_dir)
        log_path = exp_dir / "stats.jsonl"
        log_path.parent.mkdir(parents=True, exist_ok=True)
        writer = EventWriter(exp_dir / "logs")
        # Transfer overlap: the next batch is placed while this step runs.
        batches = DevicePrefetcher(iter(train_iter), to_device(self.device), depth=2)
        try:
            for batch in batches:
                with profiled_scope("coach_step"):
                    metrics = self.train_step(batch)
                if self.global_step % opts.board_interval == 0:
                    entry = {"step": self.global_step, "time": round(time.time() - start, 2),
                             **{f"Timing/{k}": round(v, 4)
                                for k, v in drain_scope_times().items()},
                             **metrics}
                    with open(log_path, "a") as f:
                        f.write(json.dumps(entry) + "\n")
                    writer.scalars(metrics, step=self.global_step)
                if opts.image_interval and self.global_step % opts.image_interval == 0:
                    x = batch[0][:4]
                    with torch.no_grad():
                        y_hat = self._restyle_forward(x, train=False,
                                                      stage=self._current_stage())[-1][0]
                    grid = save_image_grid(
                        np.concatenate([x.cpu().numpy(), y_hat.cpu().numpy()]),
                        exp_dir / "logs" / f"images_{self.global_step:06d}.png", cols=4)
                    writer.image("reconstructions", grid, step=self.global_step)
                if val_batches_fn and self.global_step % opts.val_interval == 0:
                    val = self.validate(val_batches_fn())
                    if self.best_val_loss is None or val.get("loss", np.inf) < self.best_val_loss:
                        self.best_val_loss = val.get("loss")
                        self.checkpoint(exp_dir / "checkpoints" / "best_model")
                if opts.save_interval and self.global_step % opts.save_interval == 0:
                    self.checkpoint(exp_dir / "checkpoints" / f"iteration_{self.global_step}")
                if self.global_step >= max_steps:
                    break
        finally:
            batches.close()
            writer.close()
        return self

    # --------------------------------------------------------- checkpoints

    def _named_disc(self) -> Named:
        return list(self.disc.named_parameters())

    def checkpoint(self, path) -> None:
        tree = {"variables": to_jax_variables(self.model), "latent_avg": self.latent_avg,
                "optimizer": _optimizer_tree(self.optimizer, self.trainable)}
        if self.accum_count:  # mid-accumulation; at a cycle's end it is zero
            tree["accumulator"] = {"count": np.asarray(self.accum_count, np.int64),
                                   "grads": {name: acc for (name, _), acc
                                             in zip(self.trainable, self.accum)}}
        if self.disc is not None:
            tree["disc_variables"] = to_jax_variables(self.disc)
            tree["disc_optimizer"] = _optimizer_tree(self.disc_optimizer, self._named_disc())
        meta = {"opts": dataclasses.asdict(self.opts), "global_step": self.global_step,
                "best_val_loss": self.best_val_loss, "is_e4e": self.is_e4e}
        save_pytree(path, tree, meta)

    def restore(self, path) -> "Coach":
        """Read a checkpoint this coach's `checkpoint` wrote."""
        tree, meta = load_pytree(path)
        self.load_jax_state(tree["variables"], tree["latent_avg"],
                            tree.get("disc_variables") if self.disc is not None else None)
        _load_optimizer(self.optimizer, self.trainable, tree["optimizer"])
        accum = tree.get("accumulator", {"count": 0, "grads": {}})
        self.accum_count = int(accum["count"])
        with torch.no_grad():
            for (name, _), acc in zip(self.trainable, self.accum):
                if name in accum["grads"]:
                    acc.copy_(self._tensor(accum["grads"][name]))
                else:
                    acc.zero_()
        if self.disc is not None and "disc_optimizer" in tree:
            _load_optimizer(self.disc_optimizer, self._named_disc(), tree["disc_optimizer"])
        if meta:
            self.global_step = int(meta.get("global_step", 0))
            self.best_val_loss = meta.get("best_val_loss")
        return self
