"""The port's BYOL aug+train step against the JAX package's, end to end
on the CPU.

Both sides start from the same weights (JAX ``BYOLTask.init``, converted),
make their views from the same uint8 batch with the same per-sample draws
(the JAX Pallas kernel in interpret mode; the port's fused wrapper fed the
JAX ``sample_view_params`` block of the same key), and take two steps with
``warmup_epochs=0`` so that the first step's learning rate is not 0.

Tolerances. The metrics of step 1 agree to 1e-4 and those of step 2 to
1e-3. Parameters and BatchNorm statistics are compared per group by
max|a-b| over max|b|. This step is badly conditioned at a test's size: a
constant shift before a BatchNorm changes nothing, so the gradients of
BatchNorm biases and scales are differences of nearly equal terms, and
rounding moves them by several per cent. The test measures that on the
reference itself: JAX against JAX with the views scaled by (1 + 1e-6).
The port is held to three times that spread, and never looser than 1e-3
is needed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.ops.augment import BYOL_VIEW1, BYOL_VIEW2
from medical_image_segmentation_tpu.ops.pallas_augment import pallas_two_view_augment, sample_view_params
from medical_image_segmentation_tpu.train.byol_task import BYOLTask as JaxBYOLTask
from medical_image_segmentation_tpu_torch.core.convert import flax_to_state_dict
from medical_image_segmentation_tpu_torch.ops import augment as taug
from medical_image_segmentation_tpu_torch.ops.fused_augment import fused_two_view_augment
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask

torch.set_num_threads(2)

B, IN, OUT, STEPS = 4, 80, 64, 2
MEAN, STD = (57.9764,), (60.4759,)
KW = dict(arch="resnet18", in_channels=1, hidden_dim=32, proj_dim=16, num_classes=5, learning_rate=0.1,
          warmup_epochs=0, max_epochs=STEPS, total_steps=STEPS, steps_per_epoch=1)
JCFG = tuple(dataclasses.replace(v, out_size=(OUT, OUT), solarize_prob=0.5) for v in (BYOL_VIEW1, BYOL_VIEW2))
TCFG = tuple(dataclasses.replace(v, out_size=(OUT, OUT), solarize_prob=0.5)
             for v in (taug.BYOL_VIEW1, taug.BYOL_VIEW2))


def _groups(params, stats):
    """{"params": {...}, "stats": {...}} of numpy arrays, torch names."""
    return {"params": {k: v.numpy() for k, v in flax_to_state_dict(params, {}).items()},
            "stats": {k: v.numpy() for k, v in flax_to_state_dict({}, stats).items()}}


def _group_err(a, b) -> float:
    return (max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in b)
            / max(float(np.abs(b[k]).max()) for k in b))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, size=(B, IN, IN)).astype(np.uint8) for _ in range(STEPS)]
    labels = rng.integers(0, 5, size=(B,)).astype(np.int32)
    keys = [jax.random.fold_in(jax.random.key(7), s) for s in range(STEPS)]
    views = [pallas_two_view_augment(k, jnp.asarray(x), *JCFG, mean=MEAN, std=STD, dtype=jnp.float32,
                                     interpret=True) for k, x in zip(keys, batches)]
    params = [np.array(sample_view_params(k, B, IN, IN, *JCFG)) for k in keys]
    return batches, labels, views, params


@pytest.fixture(scope="module")
def jax_task():
    """The JAX task and its initial state on the host (train_step donates
    its state, so every run starts from a fresh device copy)."""
    task = JaxBYOLTask(dtype=jnp.float32, **KW)
    return task, jax.device_get(task.init(jax.random.key(0), (2 * B, OUT, OUT, 1)))


def _run_jax(jax_task, views, labels, scale=1.0):
    task, state = jax_task
    state = jax.tree.map(jnp.array, state)
    metrics = []
    for v1, v2 in views:
        state, m = task.train_step(state, v1 * scale, v2, None if labels is None else jnp.asarray(labels))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def spread(data, jax_task):
    """The reference's own sensitivity, per group: JAX against JAX with
    view 1 scaled by (1 + 1e-6)."""
    _, _, views, _ = data
    (a, _), (b, _) = (_run_jax(jax_task, views, None, s) for s in (1.0, 1.0 + 1e-6))
    ga = {"online": _groups(jax.device_get(a.params), jax.device_get(a.batch_stats)),
          "target": _groups(jax.device_get(a.target_params), jax.device_get(a.target_batch_stats))}
    gb = {"online": _groups(jax.device_get(b.params), jax.device_get(b.batch_stats)),
          "target": _groups(jax.device_get(b.target_params), jax.device_get(b.target_batch_stats))}
    return {(side, g): _group_err(gb[side][g], ga[side][g]) for side in ga for g in ga[side]}


@pytest.mark.parametrize("with_labels", [False, True])
def test_two_byol_steps_match_jax(data, jax_task, spread, with_labels):
    batches, labels, views, params = data
    labels = labels if with_labels else None
    jstate, jmetrics = _run_jax(jax_task, views, labels)

    _, state0 = jax_task
    task = BYOLTask(dtype=torch.float32, device="cpu", **KW)
    task.online.load_state_dict(flax_to_state_dict(state0.params, state0.batch_stats))
    task.target.load_state_dict(flax_to_state_dict(state0.target_params, state0.target_batch_stats))
    tmetrics = []
    for x, p, (jv1, jv2) in zip(batches, params, views):
        v1, v2 = fused_two_view_augment(torch.from_numpy(x), *TCFG, MEAN, STD, torch.float32,
                                        params=torch.from_numpy(p))
        np.testing.assert_allclose(v1.numpy(), np.asarray(jv1), atol=1e-3)
        np.testing.assert_allclose(v2.numpy(), np.asarray(jv2), atol=1e-3)
        m = task.train_step(v1, v2, None if labels is None else torch.from_numpy(labels))
        tmetrics.append({k: float(v) for k, v in m.items()})

    assert task.step == STEPS
    for step, (t, j) in enumerate(zip(tmetrics, jmetrics)):
        assert set(t) == set(j) == {"loss", "probe_loss", "probe_acc", "lr", "momentum"}
        assert t["lr"] > 0.0
        rtol = 1e-4 if step == 0 else 1e-3
        for k in ("loss", "probe_loss"):
            assert t[k] == pytest.approx(j[k], rel=rtol, abs=1e-6), (step, k)
        assert t["probe_acc"] == pytest.approx(j["probe_acc"], abs=1e-6)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)
        assert t["momentum"] == pytest.approx(j["momentum"], rel=1e-6)
    if with_labels:
        assert all(m["probe_loss"] > 0 for m in tmetrics)

    want = {"online": _groups(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)),
            "target": _groups(jax.device_get(jstate.target_params), jax.device_get(jstate.target_batch_stats))}
    online_sd = {k: v.detach().numpy() for k, v in task.online.state_dict().items()}
    target_sd = {k: v.detach().numpy() for k, v in task.target.state_dict().items()}
    for side, sd in (("online", online_sd), ("target", target_sd)):
        for group, ref in want[side].items():
            tol = max(1e-3, 3 * spread[(side, group)])
            err = _group_err({k: sd[k] for k in ref}, ref)
            assert err <= tol, (side, group, err, tol)
    # the target encoder moved by EMA only: it is still close to its start
    # and not equal to the online encoder
    start = flax_to_state_dict(state0.target_params, {})
    assert any(not np.array_equal(target_sd[k], start[k].numpy()) for k in start)
    assert any(not np.allclose(target_sd[k], online_sd["encoder." + k]) for k in start)

    if with_labels:
        jval = jax_task[0].val_step(jstate, views[0][0], jnp.asarray(labels))
        tval = task.val_step(torch.from_numpy(np.array(views[0][0])), torch.from_numpy(labels))
        for k in ("val/loss", "val/acc@1", "val/acc@5"):
            assert float(tval[k]) == pytest.approx(float(jval[k]), rel=1e-2, abs=1e-6), k
