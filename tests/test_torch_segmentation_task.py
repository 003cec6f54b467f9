"""The port's ``SegmentationTask`` against the JAX package's, on the CPU.

Both sides start from the same weights (JAX ``init``, converted) and take
two f32 steps on the same numpy batches (normalized images, disk masks)
with ``warmup_epochs=0`` and one step per epoch, so the two steps run at
two different learning rates of the per-epoch schedule.

Tolerances. The loss of step 1 agrees to 1e-4 and that of step 2 to 1e-3.
Parameters and BatchNorm statistics are compared per group by max|a-b|
over max|b|. The step is badly conditioned at a test's size, as the BYOL
step is (``test_torch_byol_task.py``): the test measures the reference's
own spread, JAX against JAX with the images scaled by (1 + 1e-6), and
holds the port to three times that, and never looser than 1e-3 is needed.
The eval metrics agree to 1e-4 (the hard Dice and IoU move only where a
logit sits on the threshold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask as JaxSegTask
from medical_image_segmentation_tpu_torch.core.convert import unet_flax_to_state_dict
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

torch.set_num_threads(2)

B, S, STEPS = 4, 64, 2
KW = dict(arch="resnet18", learning_rate=0.5, warmup_epochs=0, max_epochs=STEPS, min_lr=0.01, steps_per_epoch=1)


def disks(rng, b, s):
    yy, xx = np.mgrid[:s, :s]
    masks = np.zeros((b, s, s, 1), np.float32)
    for i in range(b):
        cy, cx = rng.integers(s // 4, 3 * s // 4, 2)
        r = rng.integers(s // 8, s // 4)
        masks[i, ..., 0] = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return masks


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        m = disks(rng, B, S)
        x = (rng.standard_normal((B, S, S, 1)) * 0.5 + 1.5 * m - 0.5).astype(np.float32)
        out.append((x, m))
    return out


def _groups(params, stats):
    return {"params": {k: v.numpy() for k, v in unet_flax_to_state_dict(params, {}).items()},
            "stats": {k: v.numpy() for k, v in unet_flax_to_state_dict({}, stats).items()}}


def _group_err(a, b) -> float:
    return (max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in b)
            / max(float(np.abs(b[k]).max()) for k in b))


def _run_jax(task, state0, batches, scale=1.0):
    state = jax.tree.map(jnp.array, state0)  # train_step donates its state
    metrics = []
    for x, m in batches:
        state, met = task.train_step(state, jnp.asarray(x * scale), jnp.asarray(m))
        metrics.append({k: float(v) for k, v in met.items()})
    return jax.device_get(state), metrics


@pytest.mark.parametrize("loss", ["dice", "dice_ce"])
def test_two_steps_match_jax(batches, loss):
    jt = JaxSegTask(loss=loss, dtype=jnp.float32, **KW)
    state0 = jax.device_get(jt.init(jax.random.key(0), (2, S, S, 1)))
    jstate, jmetrics = _run_jax(jt, state0, batches)
    spread_state, _ = _run_jax(jt, state0, batches, 1.0 + 1e-6)
    ref = _groups(jstate.params, jstate.batch_stats)
    spread = _groups(spread_state.params, spread_state.batch_stats)

    task = SegmentationTask(loss=loss, dtype=torch.float32, device="cpu", **KW)
    task.model.load_state_dict(unet_flax_to_state_dict(state0.params, state0.batch_stats))
    tmetrics = [task.train_step(torch.from_numpy(x), torch.from_numpy(m)) for x, m in batches]

    assert task.step == STEPS
    for step, (t, j) in enumerate(zip(tmetrics, jmetrics)):
        assert set(t) == set(j) == {"train/loss", "lr"}
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)
        assert float(t["train/loss"]) == pytest.approx(j["train/loss"], rel=1e-4 if step == 0 else 1e-3)
    assert tmetrics[0]["lr"] == 0.5 and tmetrics[1]["lr"] == pytest.approx(0.01 + 0.5 * 0.49)

    sd = {k: v.detach().numpy() for k, v in task.model.state_dict().items()}
    for group in ("params", "stats"):
        tol = max(1e-3, 3 * _group_err(spread[group], ref[group]))
        err = _group_err({k: sd[k] for k in ref[group]}, ref[group])
        assert err <= tol, (group, err, tol)


def test_schedule_is_per_epoch_and_ends_at_min_lr():
    kw = dict(learning_rate=1.0, warmup_epochs=2, max_epochs=5, min_lr=0.01, steps_per_epoch=3)
    jt = JaxSegTask(**kw)
    task = SegmentationTask(**kw)
    got = [task.schedule(s) for s in range(15)]
    want = [float(jt.schedule(s)) for s in range(15)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[3] == got[4] == got[5]  # held over the epoch
    assert got[0] == 0.0 and got[14] > 0.01 and min(got[6:]) >= 0.01


@pytest.fixture(scope="module")
def eval_pair(batches):
    jt = JaxSegTask(dtype=jnp.float32, **KW)
    state = jax.device_get(jt.init(jax.random.key(1), (2, S, S, 1)))
    task = SegmentationTask(dtype=torch.float32, **KW)
    task.model.load_state_dict(unet_flax_to_state_dict(state.params, state.batch_stats))
    return jt, state, task


def test_eval_step_matches_jax(eval_pair, batches):
    jt, state, task = eval_pair
    x, m = batches[0]
    want = jt.eval_step(state, jnp.asarray(x), jnp.asarray(m))
    got = task.eval_step(torch.from_numpy(x), torch.from_numpy(m))
    assert set(got) == set(want) == {"loss", "dice", "iou"}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k
    assert task.model.training  # eval leaves the model in train mode


def test_predict_step_matches_jax(eval_pair, batches):
    jt, state, task = eval_pair
    x = batches[1][0]
    want = np.asarray(jt.predict_step(state, jnp.asarray(x)))
    got = task.predict_step(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, S, S, 1) and set(np.unique(got)) <= {0.0, 1.0}
    assert (got == want).mean() >= 0.999


def test_init_is_seeded_and_resets_the_optimizer(batches):
    a, b = SegmentationTask(dtype=torch.float32), SegmentationTask(dtype=torch.float32)
    a.init(3)
    x, m = batches[0]
    a.train_step(torch.from_numpy(x), torch.from_numpy(m))
    a.init(3)
    b.init(3)
    assert a.step == 0 and not a.optimizer.state
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    with pytest.raises(ValueError, match="loss must be"):
        SegmentationTask(loss="bce")
