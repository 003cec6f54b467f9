"""The port's ``Segmentation3DTask``, volumetric ``BYOLTask`` and 3D encoder
graft against the JAX package's, on the CPU.

Both sides start from the same weights (the JAX ``init``, converted) and
take two f32 steps on the same numpy batches at ``features=(4, 8, 16)`` on
8×16×16 crops, with ``warmup_epochs=0`` and one step per epoch, so the two
steps run at two learning rates of the schedule.

Tolerances. The loss of step 1 agrees to 1e-4 and that of step 2 to 1e-3.
Parameters (and BatchNorm statistics, where there are any) are compared
per group by max|a-b| over max|b| and held to three times the reference's
own spread, JAX against JAX with the input scaled by (1 + 1e-6), and never
looser than 1e-3 is needed: the measure of
``test_torch_segmentation_task.py``. The eval metrics agree to 1e-4. The
graft moves tensors and nothing else, so it is held to equality.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.core.checkpoint import load_byol3d_encoder_into_unet3d as jax_graft
from medical_image_segmentation_tpu.train.byol_task import BYOLTask as JaxBYOLTask
from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask as JaxSeg3DTask
from medical_image_segmentation_tpu_torch.core import checkpoint as tckpt
from medical_image_segmentation_tpu_torch.core.convert import flax_to_state_dict, unet3d_flax_to_state_dict
from medical_image_segmentation_tpu_torch.models.unet3d import UNet3D
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

torch.set_num_threads(2)

B, CROP, STEPS = 2, (8, 16, 16), 2
FEATURES = (4, 8, 16)
KW = dict(features=FEATURES, learning_rate=0.5, warmup_epochs=0, max_epochs=STEPS, min_lr=0.01, steps_per_epoch=1)
BYOL_KW = dict(volumetric=True, features3d=FEATURES, in_channels=1, hidden_dim=32, proj_dim=16, num_classes=2,
               learning_rate=0.1, warmup_epochs=0, max_epochs=STEPS, total_steps=STEPS, steps_per_epoch=1,
               probe_loss_weight=0.0)


def spheres(rng, b, dims):
    zz, yy, xx = np.mgrid[:dims[0], :dims[1], :dims[2]]
    masks = np.zeros((b, *dims, 1), np.float32)
    for i in range(b):
        c = [rng.integers(n // 4, 3 * n // 4) for n in dims]
        r = rng.integers(min(dims) // 4, min(dims) // 2)
        masks[i, ..., 0] = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= r * r
    return masks


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        m = spheres(rng, B, CROP)
        out.append(((rng.standard_normal((B, *CROP, 1)) * 0.5 + 1.5 * m - 0.5).astype(np.float32), m))
    return out


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


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


@pytest.mark.parametrize("norm,loss", [("group", "dice"), ("group", "dice_ce"), ("batch", "dice")])
def test_two_steps_match_jax(batches, norm, loss):
    jt = JaxSeg3DTask(norm=norm, loss=loss, dtype=jnp.float32, **KW)
    state0 = jax.device_get(jt.init(jax.random.key(0), (1, *CROP, 1)))
    jstate, jmetrics = _run_jax(jt, state0, batches)
    spread_state, _ = _run_jax(jt, state0, batches, 1.0 + 1e-6)

    task = Segmentation3DTask(norm=norm, loss=loss, dtype=torch.float32, device="cpu", **KW)
    task.model.load_state_dict(unet3d_flax_to_state_dict(state0.params, state0.batch_stats))
    tmetrics = [task.train_step(torch.from_numpy(x), torch.from_numpy(m)) for x, m in batches]

    assert task.step == STEPS
    for step, (t, j) in enumerate(zip(tmetrics, jmetrics)):
        assert set(t) == set(j) == {"train/loss", "lr"}
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)
        assert float(t["train/loss"]) == pytest.approx(j["train/loss"], rel=1e-4 if step == 0 else 1e-3)
    assert tmetrics[0]["lr"] == 0.5 and tmetrics[1]["lr"] == pytest.approx(0.01 + 0.5 * 0.49)

    sd = _np(task.model.state_dict())
    groups = [("params", lambda s: unet3d_flax_to_state_dict(s.params, {}))]
    if norm == "batch":
        groups.append(("stats", lambda s: unet3d_flax_to_state_dict({}, s.batch_stats)))
    covered = set()
    for group, pick in groups:
        ref, spread = _np(pick(jstate)), _np(pick(spread_state))
        tol = max(1e-3, 3 * _group_err(spread, ref))
        err = _group_err({k: sd[k] for k in ref}, ref)
        assert err <= tol, (group, err, tol)
        covered |= set(ref)
    assert covered == set(sd)
    moved = _np(unet3d_flax_to_state_dict(state0.params, {}))
    assert all(not np.array_equal(sd[k], moved[k]) for k in moved)  # every parameter took the steps


def test_schedule_is_per_epoch_and_ends_at_min_lr():
    kw = dict(features=FEATURES, learning_rate=1.0, warmup_epochs=2, max_epochs=5, min_lr=0.01, steps_per_epoch=3)
    jt = JaxSeg3DTask(**kw)
    task = Segmentation3DTask(device="cpu", **kw)
    got = [task.schedule(s) for s in range(15)]
    np.testing.assert_allclose(got, [float(jt.schedule(s)) for s in range(15)], rtol=1e-6, atol=1e-7)
    assert got[3] == got[4] == got[5] and got[0] == 0.0 and min(got[6:]) >= 0.01


@pytest.fixture(scope="module")
def eval_pair():
    jt = JaxSeg3DTask(dtype=jnp.float32, **KW)
    state = jax.device_get(jt.init(jax.random.key(1), (1, *CROP, 1)))
    task = Segmentation3DTask(dtype=torch.float32, device="cpu", **KW)
    task.model.load_state_dict(unet3d_flax_to_state_dict(state.params, state.batch_stats))
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


def test_predict_step_and_logits_match_jax(eval_pair, batches):
    jt, state, task = eval_pair
    x = batches[1][0]
    want = np.asarray(jt.predict_step(state, jnp.asarray(x)))
    got = task.predict_step(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, *CROP, 1) and set(np.unique(got)) <= {0.0, 1.0}
    assert (got == want).mean() >= 0.999
    logits = task.logits(torch.from_numpy(x))
    want_logits = np.asarray(jt.model.apply({"params": state.params}, jnp.asarray(x), train=False))
    assert logits.dtype == torch.float32 and not logits.requires_grad
    assert float(np.abs(logits.numpy() - want_logits).max() / np.abs(want_logits).max()) <= 1e-4


def test_state_dict_round_trip_init_and_errors(batches):
    a, b = (Segmentation3DTask(dtype=torch.float32, device="cpu", **KW) for _ in range(2))
    a.init(3)
    x, m = (torch.from_numpy(t) for t in batches[0])
    a.train_step(x, m)
    b.load_state_dict(copy.deepcopy(a.state_dict()))  # a file would not alias a's momentum buffers
    assert b.step == 1
    la, lb = a.train_step(x, m)["train/loss"], b.train_step(x, m)["train/loss"]
    assert torch.equal(la, lb)  # weights, momentum buffers and step came across
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    a.init(3)
    b.init(3)
    assert a.step == 0 and not a.optimizer.state
    assert all(torch.equal(va, vb) for va, vb in zip(a.model.state_dict().values(), b.model.state_dict().values()))
    with pytest.raises(ValueError, match="loss must be"):
        Segmentation3DTask(loss="bce", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Segmentation3DTask()  # the card is the default and there is none here


# ---------------------------------------------------------- volumetric BYOL


def _byol_groups(params, stats):
    return {"params": _np(flax_to_state_dict(params, {})), "stats": _np(flax_to_state_dict({}, stats))}


def _run_jax_byol(task, state0, views, scale=1.0):
    state = jax.tree.map(jnp.array, state0)
    metrics = []
    for v1, v2 in views:
        state, m = task.train_step(state, jnp.asarray(v1 * scale), jnp.asarray(v2))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state), metrics


def test_two_volumetric_byol_steps_match_jax():
    rng = np.random.default_rng(5)
    views = [tuple(rng.standard_normal((B, *CROP, 1)).astype(np.float32) for _ in range(2)) for _ in range(STEPS)]
    jt = JaxBYOLTask(dtype=jnp.float32, **BYOL_KW)
    state0 = jax.device_get(jt.init(jax.random.key(0), (1, *CROP, 1)))
    jstate, jmetrics = _run_jax_byol(jt, state0, views)
    sstate, _ = _run_jax_byol(jt, state0, views, 1.0 + 1e-6)

    task = BYOLTask(dtype=torch.float32, device="cpu", **BYOL_KW)
    task.online.load_state_dict(flax_to_state_dict(state0.params, state0.batch_stats))
    task.target.load_state_dict(flax_to_state_dict(state0.target_params, state0.target_batch_stats))
    tmetrics = [task.train_step(torch.from_numpy(v1), torch.from_numpy(v2)) for v1, v2 in views]

    for step, (t, j) in enumerate(zip(tmetrics, jmetrics)):
        tol = 1e-4 if step == 0 else 1e-3
        assert float(t["loss"]) == pytest.approx(j["loss"], rel=tol)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6) and t["momentum"] == pytest.approx(j["momentum"], rel=1e-6)
        assert float(t["probe_loss"]) == 0.0
    sides = {"online": (task.online, lambda s: (s.params, s.batch_stats)),
             "target": (task.target, lambda s: (s.target_params, s.target_batch_stats))}
    for side, (module, pick) in sides.items():
        sd = _np(module.state_dict())
        ref, spread = _byol_groups(*pick(jstate)), _byol_groups(*pick(sstate))
        assert set(ref["params"]) | set(ref["stats"]) == set(sd)
        for group in ("params", "stats"):
            tol = max(1e-3, 3 * _group_err(spread[group], ref[group]))
            err = _group_err({k: sd[k] for k in ref[group]}, ref[group])
            assert err <= tol, (side, group, err, tol)
    assert any(k.startswith("encoder.backbone.enc2.") for k in task.online.state_dict())


# ------------------------------------------------------------------ the graft


@pytest.fixture(scope="module")
def graft_inputs():
    jb = JaxBYOLTask(dtype=jnp.float32, **BYOL_KW)
    bstate = jax.device_get(jb.init(jax.random.key(2), (1, *CROP, 1)))
    ju = JaxSeg3DTask(dtype=jnp.float32, **KW)
    ustate = jax.device_get(ju.init(jax.random.key(3), (1, *CROP, 1)))
    return bstate, ustate


def test_graft_matches_jax_leaf_for_leaf(graft_inputs):
    bstate, ustate = graft_inputs
    want = jax_graft({"params": ustate.params, "batch_stats": ustate.batch_stats},
                     {"params": bstate.params, "batch_stats": bstate.batch_stats})
    want = _np(unet3d_flax_to_state_dict(want["params"], want.get("batch_stats", {})))
    online = flax_to_state_dict(bstate.params, bstate.batch_stats)
    unet_sd = unet3d_flax_to_state_dict(ustate.params, ustate.batch_stats)
    got = _np(tckpt.load_byol3d_encoder_into_unet3d(unet_sd, online))
    assert set(got) == set(want) == set(unet_sd)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if k.startswith(("enc", "down")):  # every encoder leaf is the BYOL online backbone's
            np.testing.assert_array_equal(got[k], online["encoder.backbone." + k].numpy(), err_msg=k)
            assert k.endswith("norm1.weight") or k.endswith("norm2.weight") or k.endswith("bias") \
                or not np.array_equal(got[k], unet_sd[k].numpy()), k
        else:  # every decoder and head leaf is untouched
            np.testing.assert_array_equal(got[k], unet_sd[k].numpy(), err_msg=k)
    assert sum(k.startswith("dec") for k in got) == 12 and "head.weight" in got
    UNet3D(features=FEATURES).load_state_dict({k: torch.from_numpy(v) for k, v in got.items()})


def test_graft_raises_on_a_missing_block_a_mismatch_and_a_2d_checkpoint(graft_inputs):
    bstate, _ = graft_inputs
    online = flax_to_state_dict(bstate.params, bstate.batch_stats)
    with pytest.raises(ValueError, match=r"UNet3D has no blocks \['down1', 'enc2'\] to graft into"):
        tckpt.load_byol3d_encoder_into_unet3d(UNet3D(features=(4, 8)).state_dict(), online)
    with pytest.raises(ValueError, match=r"3D encoder shape mismatches: \[.*\('enc0.conv1.weight', \(4, 1, 3, 3, 3\), "
                                         r"\(8, 1, 3, 3, 3\)\)"):
        tckpt.load_byol3d_encoder_into_unet3d(UNet3D(features=(8, 16, 32)).state_dict(), online)
    with pytest.raises(ValueError, match="3D encoder shape mismatches.*norm1.weight"):  # the other norm's leaves
        tckpt.load_byol3d_encoder_into_unet3d(
            {k: v for k, v in UNet3D(features=FEATURES).state_dict().items() if "norm1.weight" not in k}, online)
    flat = BYOLTask(arch="resnet18", in_channels=1, hidden_dim=8, proj_dim=4, device="cpu")
    with pytest.raises(ValueError, match="no volumetric"):
        tckpt.load_byol3d_encoder_into_unet3d(UNet3D(features=FEATURES).state_dict(), flat.online.state_dict())
