"""Data-parallel steps of the PyTorch port in two gloo ranks on the CPU,
against the port's one-rank step and the JAX package's step on a
2-device ``data`` mesh.

Every case starts from the JAX task's initial weights (converted through
``core/convert.py``) and takes two f32 steps with ``warmup_epochs=0`` on a
global batch of 4: each rank takes its 2 rows (``parallel/mesh.py::
data_rows``), the one-rank port step and the JAX step take all 4 (the JAX
batch sharded over two of its virtual CPU devices, so XLA reduces the
BatchNorm statistics, the Dice sums and the gradients across them). Cases:
BYOL (labels on, so the probe trains too; the target after the EMA), the
2D U-Net with Dice, whose two ranks hold very different mask fractions,
and the 3D U-Net with GroupNorm and with ``--norm batch``.

Tolerances. Parameters and BatchNorm statistics are compared per group by
max|a-b| over max|b|, as in ``test_torch_byol_task.py``: these steps are
badly conditioned at a test's size (a bias before a BatchNorm has a
gradient of rounding noise), so each reference's own spread under a 1e-6
change of the input is measured and the two-rank step is held to three
times that (against JAX, the larger of JAX's and the port's own spreads),
never looser than 1e-3 against JAX (as the one-card parity
tests) and never looser than 1e-5 against the port's one-rank step. The
metrics agree with the one-rank step to 1e-5 relative at step 1 and 1e-3
at step 2 (whose inputs went through the ill-conditioned first update), or
three times that step's own spread, and with JAX to 1e-4 (step 1) and 1e-3 (step 2). The ranks end bit-equal.

The wrong loss must fail: the same segmentation steps trained on each
rank's own Dice (averaged over the ranks by the gradient all-reduce) miss
the tolerance and report another loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from medical_image_segmentation_tpu.parallel import make_mesh, replicated, shard_batch
from medical_image_segmentation_tpu.train.byol_task import BYOLTask as JaxBYOLTask
from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask as JaxSeg3DTask
from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask as JaxSegTask
from medical_image_segmentation_tpu_torch.core.convert import (
    flax_to_state_dict, unet3d_flax_to_state_dict, unet_flax_to_state_dict,
)

torch.set_num_threads(2)

B, STEPS, RANKS = 4, 2, 2
BYOL_KW = dict(arch="resnet18", in_channels=1, hidden_dim=32, proj_dim=16, num_classes=5, learning_rate=0.1,
               warmup_epochs=0, max_epochs=STEPS, total_steps=STEPS, steps_per_epoch=1)
SEG_KW = dict(arch="resnet18", learning_rate=0.5, warmup_epochs=0, max_epochs=STEPS, min_lr=0.01, steps_per_epoch=1)
SEG3D_KW = dict(features=(4, 8, 16), learning_rate=0.5, warmup_epochs=0, max_epochs=STEPS, min_lr=0.01,
                steps_per_epoch=1)
S, CROP = 64, (8, 16, 16)


def _group_err(a, b, keys) -> float:
    return (max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in keys)
            / max(float(np.abs(b[k]).max()) for k in keys))


def _groups(sd):
    """{"params": keys, "stats": keys} of a state dict."""
    stats = [k for k in sd if "running_" in k]
    return {"params": [k for k in sd if k not in stats], "stats": stats}


def _disks(rng, radii, dims):
    grid = np.mgrid[tuple(slice(0, d) for d in dims)]
    masks = np.zeros((len(radii), *dims, 1), np.float32)
    for i, r in enumerate(radii):
        c = [rng.integers(d // 4, 3 * d // 4) for d in dims]
        masks[i, ..., 0] = sum((g - ci) ** 2 for g, ci in zip(grid, c)) <= r * r
    return masks


def _seg_batches(rng, dims, radii):
    """Images and masks whose first half (rank 0) holds large objects and
    whose second half (rank 1) small or none."""
    out = []
    for _ in range(STEPS):
        m = _disks(rng, radii, dims)
        out.append(((rng.standard_normal((B, *dims, 1)) * 0.5 + 1.5 * m - 0.5).astype(np.float32), m))
    return out


def _jax_init(task, shape):
    """``task.init`` under one ``jit`` (its eager form compiles op by op)."""
    return jax.device_get(jax.jit(lambda key: task.init(key, shape))(jax.random.key(0)))


def _jax_sharded(task, state0, steps, scale=1.0):
    """The JAX steps with the batch sharded over a 2-device data mesh."""
    mesh = make_mesh(jax.devices()[:RANKS])
    state = jax.device_put(jax.tree.map(jnp.array, state0), replicated(mesh))
    metrics = []
    for batch in steps:
        args = shard_batch(mesh, (jnp.asarray(batch[0]) * scale, *map(jnp.asarray, batch[1:])))
        state, m = task.train_step(state, *args)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state), metrics


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Per case: the JAX result and its spread, the port's one-rank result
    and its spread, and what each of the two ranks returned. The ranks
    start as soon as the initial weights are written and run every case in
    one launch while this process runs the references."""
    d = tmp_path_factory.mktemp("ddp")
    rng = np.random.default_rng(0)
    out, calls, refs = {}, [], []

    jt = JaxBYOLTask(dtype=jnp.float32, **BYOL_KW)
    s0 = _jax_init(jt, (2 * B, S, S, 1))
    steps = [(rng.standard_normal((B, S, S, 1)).astype(np.float32),
              rng.standard_normal((B, S, S, 1)).astype(np.float32),
              rng.integers(0, 5, B).astype(np.int32)) for _ in range(STEPS)]
    init = {"online": flax_to_state_dict(s0.params, s0.batch_stats),
            "target": flax_to_state_dict(s0.target_params, s0.target_batch_stats)}
    for name, scale in (("byol", 1.0), ("byol_spread", 1.0 + 1e-6)):
        torch.save({**init, "steps": [(v1 * scale, v2, y) for v1, v2, y in steps]}, d / f"{name}.pt")
    calls.append((td.byol_steps, (str(d / "byol.pt"), BYOL_KW)))
    refs.append(("byol", jt, s0, steps, flax_to_state_dict, td.byol_steps, (BYOL_KW,)))

    seg_cases = [("seg", JaxSegTask(dtype=jnp.float32, **SEG_KW), SEG_KW, (S, S), False, unet_flax_to_state_dict),
                 ("seg3d_group", JaxSeg3DTask(norm="group", dtype=jnp.float32, **SEG3D_KW),
                  dict(norm="group", **SEG3D_KW), CROP, True, unet3d_flax_to_state_dict),
                 ("seg3d_batch", JaxSeg3DTask(norm="batch", dtype=jnp.float32, **SEG3D_KW),
                  dict(norm="batch", **SEG3D_KW), CROP, True, unet3d_flax_to_state_dict)]
    for name, jt, kw, dims, vol, convert in seg_cases:
        s0 = _jax_init(jt, (1, *dims, 1))
        steps = _seg_batches(rng, dims, [dims[-1] // 3, dims[-1] // 4, 1, 0])
        init = convert(s0.params, s0.batch_stats)
        torch.save({"model": init, "steps": steps}, d / f"{name}.pt")
        torch.save({"model": init, "steps": [(x * (1 + 1e-6), m) for x, m in steps]}, d / f"{name}_spread.pt")
        calls.append((td.seg_steps, (str(d / f"{name}.pt"), kw, vol)))
        refs.append((name, jt, s0, steps, convert, td.seg_steps, (kw, vol)))
        out[name] = {"fractions": [float(np.mean([m[half].mean() for _, m in steps]))
                                   for half in (slice(0, B // 2), slice(B // 2, B))]}
    calls.append((td.seg_steps, (str(d / "seg.pt"), SEG_KW, False, True)))

    ranks = td.Launch(td.run_all, RANKS, calls)
    for name, jt, s0, steps, convert, port_fn, port_args in refs:
        res = out.setdefault(name, {})
        for key, scale in (("jax", 1.0), ("jax_spread", 1.0 + 1e-6)):
            js, jm = _jax_sharded(jt, s0, steps, scale)
            if name == "byol":
                res[key] = ({"online": _np(flax_to_state_dict(js.params, js.batch_stats)),
                             "target": _np(flax_to_state_dict(js.target_params, js.target_batch_stats))}, jm)
            else:
                res[key] = ({"model": _np(convert(js.params, js.batch_stats))}, jm)
        res["one"] = port_fn(str(d / f"{name}.pt"), *port_args)
        res["one_spread"] = port_fn(str(d / f"{name}_spread.pt"), *port_args)
    for r, results in enumerate(ranks.results()):
        for name, result in zip([ref[0] for ref in refs] + ["seg_local_dice"], results):
            out.setdefault(name, {})[f"rank{r}"] = result
    return out


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _states(res, case):
    """{side: state dict} of a result."""
    return {"online": res["online"], "target": res["target"]} if case == "byol" else {"model": res["model"]}


@pytest.mark.parametrize("case", ["byol", "seg", "seg3d_group", "seg3d_batch"])
def test_two_ranks_equal_the_one_rank_step_and_jax_sharded(cases, case):
    c = cases[case]
    loss = "loss" if case == "byol" else "train/loss"
    (jstates, jmetrics), (jspread, _) = c["jax"], c["jax_spread"]
    one, one_spread = _states(c["one"], case), _states(c["one_spread"], case)
    for r in range(RANKS):
        res = c[f"rank{r}"]
        for step, (m, m1, ms, mj) in enumerate(zip(res["metrics"], c["one"]["metrics"], c["one_spread"]["metrics"],
                                                   jmetrics)):
            rel = max(1e-5 if step == 0 else 1e-3, 3 * abs(ms[loss] - m1[loss]) / abs(m1[loss]))
            assert m["lr"] == m1["lr"] and m[loss] == pytest.approx(m1[loss], rel=rel), (step, m, m1)
            assert m[loss] == pytest.approx(mj[loss], rel=1e-4 if step == 0 else 1e-3), (step, m, mj)
            if case == "byol":
                for k in ("probe_loss", "probe_acc", "momentum"):
                    rel = max(1e-5 if step == 0 else 1e-3, 3 * abs(ms[k] - m1[k]) / max(abs(m1[k]), 1e-6))
                    assert m[k] == pytest.approx(m1[k], rel=rel, abs=1e-6), (step, k)
                    assert m[k] == pytest.approx(mj[k], rel=1e-3, abs=1e-6), (step, k)
        for side, sd in _states(res, case).items():
            for group, keys in _groups(one[side]).items():
                if not keys:
                    continue
                tol = max(1e-5, 3 * _group_err(one_spread[side], one[side], keys))
                err = _group_err(sd, one[side], keys)
                assert err <= tol, ("one-rank", side, group, err, tol)
                jkeys = [k for k in keys if k in jstates[side]]
                assert jkeys == keys  # the converted JAX state covers every entry
                spread = max(_group_err(jspread[side], jstates[side], keys),
                             _group_err(one_spread[side], one[side], keys))
                tol = max(1e-3, 3 * spread)
                err = _group_err(sd, jstates[side], keys)
                assert err <= tol, ("jax", side, group, err, tol)
    if case != "byol":
        for k in ("loss", "dice", "iou"):
            assert c["rank0"]["eval"][k] == pytest.approx(c["one"]["eval"][k], rel=1e-5, abs=1e-6), k


@pytest.mark.parametrize("case", ["byol", "seg", "seg3d_group", "seg3d_batch"])
def test_ranks_end_bit_equal(cases, case):
    a, b = (_states(cases[case][f"rank{r}"], case) for r in range(RANKS))
    for side in a:
        for k in a[side]:
            assert np.array_equal(a[side][k], b[side][k]), (side, k)
    assert cases[case]["rank0"]["metrics"] == cases[case]["rank1"]["metrics"]


def test_the_ranks_hold_different_mask_fractions_and_per_rank_dice_is_another_loss(cases):
    """What makes the Dice cases discriminating: rank 0's rows are
    foreground-heavy and rank 1's nearly empty, so each rank's own Dice,
    averaged over the ranks, is another number than the global Dice."""
    for case in ("seg", "seg3d_group", "seg3d_batch"):
        f0, f1 = cases[case]["fractions"]
        assert f0 > 20 * f1, (case, f0, f1)
    wrong = cases["seg_local_dice"]["rank0"]["metrics"][0]["train/loss"]
    assert wrong != pytest.approx(cases["seg"]["one"]["metrics"][0]["train/loss"], rel=1e-2)


def test_per_rank_dice_would_miss_the_tolerance(cases):
    c = cases["seg"]
    one, one_spread = c["one"]["model"], c["one_spread"]["model"]
    keys = _groups(one)["params"]
    tol = max(1e-5, 3 * _group_err(one_spread, one, keys))
    assert _group_err(c["rank0"]["model"], one, keys) <= tol
    wrong = _group_err(cases["seg_local_dice"]["rank0"]["model"], one, keys)
    assert wrong > 3 * tol, (wrong, tol)
