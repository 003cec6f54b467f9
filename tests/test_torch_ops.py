"""The port's BYOL loss, schedules and LARS against the JAX package's.

Inputs come from numpy with a seed and go to both packages as arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medical_image_segmentation_tpu.ops import byol_loss as jloss
from medical_image_segmentation_tpu.ops import schedules as jsched
from medical_image_segmentation_tpu.ops.lars import lars, make_lars_mask
from medical_image_segmentation_tpu_torch.ops import byol_loss as tloss
from medical_image_segmentation_tpu_torch.ops import schedules as tsched
from medical_image_segmentation_tpu_torch.ops.lars import LARS

torch.set_num_threads(2)


# ------------------------------------------------------------------ loss


def test_byol_loss_and_gradient_match_jax_including_a_zero_vector():
    """f32 sums of 16 terms: 1e-6 relative. The zero row is where
    ``F.normalize`` would differ; rsqrt(Σx²+eps²) keeps it finite."""
    rng = np.random.default_rng(0)
    preds = rng.standard_normal((6, 16)).astype(np.float32)
    targets = rng.standard_normal((6, 16)).astype(np.float32)
    preds[2] = 0.0
    targets[4] = 0.0
    want, want_grad = jax.value_and_grad(jloss.cosine_similarity_loss)(jnp.asarray(preds), jnp.asarray(targets))
    p = torch.from_numpy(preds).requires_grad_(True)
    t = torch.from_numpy(targets).requires_grad_(True)
    got = tloss.cosine_similarity_loss(p, t)
    got.backward()
    assert t.grad is None  # targets are stop-gradiented
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert torch.isfinite(p.grad).all()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("interval", ["step", "epoch"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_jax(interval, warmup):
    """JAX evaluates in f32, the port in f64 on the host: 1e-6."""
    kw = dict(base_lr=1.2, warmup_epochs=warmup, max_epochs=10, warmup_start_lr=0.01, eta_min=0.002,
              steps_per_epoch=7, interval=interval)
    j, t = jsched.linear_warmup_cosine_annealing(**kw), tsched.linear_warmup_cosine_annealing(**kw)
    steps = np.arange(0, 75)
    want = np.asarray(jax.vmap(j)(jnp.asarray(steps)))
    got = np.array([t(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_lr_schedule_warmup_starts_at_zero():
    s = tsched.linear_warmup_cosine_annealing(1.0, warmup_epochs=10, max_epochs=100, steps_per_epoch=5,
                                              interval="step")
    assert s(0) == 0.0 and s(1) > 0.0
    assert tsched.linear_warmup_cosine_annealing(1.0, 0, 100, steps_per_epoch=5, interval="step")(0) == 1.0


def test_ema_momentum_schedule_matches_jax():
    j, t = jsched.cosine_ema_momentum(0.99, 1.0), tsched.cosine_ema_momentum(0.99, 1.0)
    total = 37
    want = np.asarray(jax.vmap(lambda s: j(s, total))(jnp.arange(total + 1)))
    got = np.array([t(s, total) for s in range(total + 1)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(0.99) and got[-1] == pytest.approx(1.0)


# ------------------------------------------------------------------ LARS

SHAPES = {
    "dense": (6, 4),          # rank 2: adapted and decayed
    "conv": (3, 3, 2, 5),     # rank 4: adapted and decayed
    "bias": (5,),             # rank 1: neither
    "zero_grad": (4, 3),      # rank 2 with an all-zero gradient: tr = 1
    "no_grad": (3, 3),        # rank 2 whose torch .grad stays None (JAX sees zeros)
    "no_grad_bias": (3,),     # rank 1 whose torch .grad stays None
}


@pytest.mark.parametrize("weight_decay,nesterov", [(1e-6, False), (0.05, False), (0.05, True)])
def test_lars_matches_optax_over_five_steps(weight_decay, nesterov):
    """Five steps on identical gradients and a changing learning rate.
    Per-leaf f32 norms and updates: 1e-6 relative, 1e-7 absolute."""
    rng = np.random.default_rng(1)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    lrs = [0.5, 0.4, 0.3, 0.2, 0.1]
    tx = lars(lambda count: jnp.asarray(lrs)[count], weight_decay=weight_decay, momentum=0.9,
              nesterov=nesterov, mask=make_lars_mask)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = LARS(list(tparams.values()), lr=0.0, weight_decay=weight_decay, momentum=0.9, nesterov=nesterov)
    for step in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        grads["zero_grad"][:] = 0.0
        grads["no_grad"][:] = 0.0
        grads["no_grad_bias"][:] = 0.0
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = None if k.startswith("no_grad") else torch.from_numpy(grads[k])
        for group in opt.param_groups:
            group["lr"] = lrs[step]
        opt.step()
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # the None-grad rank-2 leaf decayed through the momentum buffer, as in JAX
    assert not np.array_equal(tparams["no_grad"].detach().numpy(), init["no_grad"])


def test_lars_refuses_a_closure():
    p = torch.nn.Parameter(torch.ones(2, 2))
    with pytest.raises(ValueError):
        LARS([p]).step(lambda: 0.0)
