"""Ranger: gradient centralisation, RAdam and Lookahead, as one optimizer.

Counterpart of the JAX package's `training/ranger.py` (reference
utils/ranger.py, the default encoder and mapper optimizer), written by hand
as a `torch.optim.Optimizer` that follows the JAX chain step for step:
1. gradient centralisation: a tensor of rank > 1 loses its mean over every
   axis but the first (the parameter layouts are the JAX package's, so the
   axes are too);
2. optional decoupled weight decay, ``g + weight_decay · p``;
3. ``optax.radam`` (b1 0.95, b2 0.999, eps 1e-5, threshold 5): moments
   ``m = (1 − b1) g + b1 m`` and ``v = (1 − b2) g² + b2 v``, bias-corrected;
   with ``ρ_t = ρ∞ − 2 t b2ᵗ / (1 − b2ᵗ)`` the step is
   ``r_t · m̂ / (√v̂ + eps)`` when ``ρ_t ≥ threshold`` (ρ₅ ≈ 4.996, ρ₆ ≈ 5.995)
   and ``m̂`` before, times −lr;
4. lookahead every k = 6 steps with α = 0.5: the fast weights are
   ``p + u``; on a sync step slow ← slow + α (fast − slow) and the fast
   weights snap to it. As in the JAX chain the snap is applied as an update,
   ``p + (new − p)``, which rounds as the JAX parameters do.

Scalars follow optax's float32 arithmetic. As in optax, one clock counts the
steps: each parameter group keeps ``step``, which every call of `step`
advances once and which drives the bias correction, the RAdam switch and
the lookahead sync of all its parameters. The state of a parameter holds
``exp_avg`` (m), ``exp_avg_sq`` (v) and ``slow``. A parameter that has no
gradient in a step takes a zero gradient, as a JAX gradient tree holds
zeros where the loss does not reach: its moments decay and it goes on
moving. Without weight decay, one that has had no gradient yet stays out of
the state, which is the same result (zero moments move nothing, and it is
its own slow copy).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


class Ranger(torch.optim.Optimizer):
    def __init__(self, params: Iterable, lr: float = 1e-3, alpha: float = 0.5, k: int = 6,
                 betas=(0.95, 0.999), eps: float = 1e-5, weight_decay: float = 0.0,
                 n_sma_threshold: float = 5.0, use_gc: bool = True):
        defaults = dict(lr=lr, alpha=alpha, k=k, betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay, n_sma_threshold=n_sma_threshold,
                        use_gc=use_gc)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure: Optional[callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            group["step"] = t = group.get("step", 0) + 1
            count = torch.tensor(float(t), dtype=torch.float32)
            b1t = torch.tensor(b1, dtype=torch.float32) ** count
            b2t = torch.tensor(b2, dtype=torch.float32) ** count
            ro = ro_inf - 2 * count * b2t / (1 - b2t)
            rectify = float(ro) >= group["n_sma_threshold"]
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                           / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            for p in group["params"]:
                if p.grad is None and p not in self.state and not group["weight_decay"]:
                    continue
                state = self.state[p]
                g = torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
                if group["use_gc"] and g.ndim > 1:
                    g = g - g.mean(dim=tuple(range(1, g.ndim)), keepdim=True)
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                if not state:
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                    state["slow"] = p.detach().clone()
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.copy_((1 - b1) * g + b1 * m)
                v.copy_((1 - b2) * g ** 2 + b2 * v)
                m_hat = m / (1 - b1t).to(m.device)
                if rectify:
                    v_hat = v / (1 - b2t).to(v.device)
                    u = r.to(m.device) * m_hat / (torch.sqrt(v_hat) + group["eps"])
                else:
                    u = m_hat
                fast = p + u * (-group["lr"])
                if t % group["k"] == 0:
                    slow = state["slow"]
                    slow.copy_(slow + group["alpha"] * (fast - slow))
                    fast = slow
                p.add_(fast - p)
        return loss


def ranger(params: Iterable, learning_rate: float = 1e-3, alpha: float = 0.5, k: int = 6,
           b1: float = 0.95, b2: float = 0.999, eps: float = 1e-5, weight_decay: float = 0.0,
           n_sma_threshold: float = 5.0, use_gc: bool = True) -> Ranger:
    """The full Ranger optimizer over ``params`` (the reference defaults)."""
    return Ranger(params, lr=learning_rate, alpha=alpha, k=k, betas=(b1, b2), eps=eps,
                  weight_decay=weight_decay, n_sma_threshold=n_sma_threshold, use_gc=use_gc)
