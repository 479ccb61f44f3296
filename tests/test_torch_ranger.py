"""The port's Ranger optimizer against the JAX package's optax chain, on the CPU.

14 steps on a 2-D weight, a bias and a rank-4 (HWIO) kernel with seeded
gradients: past RAdam's switch (ρ₅ ≈ 4.996 below the threshold of 5, ρ₆ ≈
5.995 above it) and two lookahead syncs (steps 6 and 12). After every step
the parameters, both moments and the slow weights are held to the JAX
state within fp32 rounding: 4 ulp of the largest magnitude (2⁻²¹ of max
|ref|; the two run the same float32 arithmetic, XLA fusing some of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylegan3_editing_tpu.training.ranger import ranger as jranger
from stylegan3_editing_tpu_torch.training.ranger import Ranger, ranger

STEPS = 14
RTOL = 2.0 ** -21
SHAPES = {"kernel": (5, 7), "bias": (7,), "conv": (3, 3, 4, 6)}


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape and err <= RTOL * float(np.abs(ref).max()), (what, err)


@pytest.mark.parametrize("options", [dict(), dict(weight_decay=1e-2),
                                     dict(use_gc=False), dict(learning_rate=0.5)],
                         ids=["defaults", "weight-decay", "no-gc", "mapper-lr"])
def test_ranger_matches_optax_step_for_step(options):
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * (1 + i)).astype(np.float32) for k, s in SHAPES.items()}
             for i in range(STEPS)]
    tx = jranger(**options)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ranger(tp.values(), **options)
    for step, g in enumerate(grads, start=1):
        u, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        radam = state.inner[-1][0]  # chain → radam's chain → scale_by_radam's state
        assert int(state.step) == int(radam.count) == step
        assert opt.param_groups[0]["step"] == step
        for k, p in tp.items():
            st = opt.state[p]
            _close(p.detach(), jp[k], f"step {step} {k}")
            _close(st["exp_avg"], radam.mu[k], f"step {step} {k} mu")
            _close(st["exp_avg_sq"], radam.nu[k], f"step {step} {k} nu")
            _close(st["slow"], state.slow[k], f"step {step} {k} slow")


def test_rectification_switches_on_at_step_6_and_lookahead_syncs_every_6():
    """With b2 = 0.999, ρ_t = 2/(1 − b2) − 1 − 2 t b2ᵗ / (1 − b2ᵗ) crosses the
    threshold of 5 between t = 5 (4.996) and t = 6 (5.995): up to step 5
    the step is lr · m̂ alone (a unit gradient moves a weight by lr), from
    step 6 on it is rectified. The slow weights change at steps 6 and 12
    only."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = Ranger([p], lr=0.1, use_gc=False)
    moves, slow = [], []
    for _ in range(12):
        before = p.detach().clone()
        p.grad = torch.ones(3)
        opt.step()
        moves.append(float((before - p.detach())[0]))
        slow.append(float(opt.state[p]["slow"][0]))
    np.testing.assert_allclose(moves[:5], 0.1, rtol=1e-6)
    b2 = 0.999
    ro = [2 / (1 - b2) - 1 - 2 * t * b2 ** t / (1 - b2 ** t) for t in (5, 6)]
    assert ro[0] < 5 <= ro[1]
    assert abs(ro[0] - 4.996) < 1e-3 and abs(ro[1] - 5.995) < 1e-3
    assert slow[:5] == [0.0] * 5 and slow[5] != 0.0
    assert slow[6:11] == [slow[5]] * 5 and slow[11] != slow[5]
    assert float(p.detach()[0]) == slow[11]  # the fast weights snap to the slow ones


def test_ranger_skips_parameters_without_gradients():
    a, b = torch.nn.Parameter(torch.ones(2, 2)), torch.nn.Parameter(torch.ones(2))
    opt = ranger([a, b], 0.1)
    a.grad = torch.ones(2, 2)
    opt.step()
    assert b not in opt.state and torch.equal(b.detach(), torch.ones(2))
    assert opt.param_groups[0]["step"] == 1 and set(opt.state[a]) == {"exp_avg", "exp_avg_sq",
                                                                       "slow"}


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["no-decay", "weight-decay"])
def test_ranger_keeps_one_clock_when_gradients_are_missing(weight_decay):
    """optax counts one step for every leaf and sees a zero gradient where
    the loss does not reach. Here the bias has no gradient for its first 3
    steps and the conv loses its gradient after step 4; the port, given no
    ``.grad`` there, follows optax given zeros through both lookahead syncs."""
    rng = np.random.RandomState(1)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    missing = {"bias": range(1, 4), "conv": range(5, STEPS + 1)}
    grads = [{k: (np.zeros(s) if step in missing.get(k, ()) else rng.randn(*s))
              .astype(np.float32) for k, s in SHAPES.items()}
             for step in range(1, STEPS + 1)]
    tx = jranger(weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ranger(tp.values(), weight_decay=weight_decay)
    for step, g in enumerate(grads, start=1):
        u, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in tp.items():
            p.grad = None if step in missing.get(k, ()) else torch.from_numpy(g[k])
        opt.step()
        if step < 4 and not weight_decay:
            assert tp["bias"] not in opt.state
        for k, p in tp.items():
            _close(p.detach(), jp[k], f"step {step} {k}")
            if p in opt.state:
                _close(opt.state[p]["slow"], state.slow[k], f"step {step} {k} slow")
    assert not torch.equal(tp["conv"].detach(), torch.from_numpy(params["conv"]))
