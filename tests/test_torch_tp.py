"""Tensor-parallel BYOL heads of the PyTorch port (``--model_parallel``,
``parallel/tp.py``) in gloo ranks on the CPU, against the port's
replicated one-rank step and the JAX package's step with its heads
sharded by ``byol_tp_shardings`` over a (data=2, model=2) mesh of virtual
CPU devices.

Two layouts: (data=1, model=2) on 2 ranks and (data=2, model=2) on 4.
Both start from the JAX task's initial weights (converted, then each rank
keeps its slices of the heads) and take two f32 steps with labels on a
global batch of 4. The tolerances are those of ``test_torch_ddp.py``: per
group of parameters or statistics, three times the reference's own spread
under a 1e-6 change of the input (against JAX, the larger of JAX's and the
port's own spreads), at least 1e-5 against the one-rank step and 1e-3
against JAX; step-1 metrics to 1e-5 of the one-rank step.

A checkpoint of the 2-rank run is laid out as a one-card one: it loads
into a one-rank task, whose forward equals the tensor-parallel forward,
and back into a tensor-parallel task, whose gathered state equals it bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from medical_image_segmentation_tpu.parallel import byol_tp_shardings, data_sharding, make_mesh
from medical_image_segmentation_tpu.train.byol_task import BYOLTask as JaxBYOLTask
from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint
from medical_image_segmentation_tpu_torch.core.convert import flax_to_state_dict
from medical_image_segmentation_tpu_torch.parallel.tp import shard_dim
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask

torch.set_num_threads(2)

B, S, STEPS, HIDDEN = 4, 64, 2, 32
KW = dict(arch="resnet18", in_channels=1, hidden_dim=HIDDEN, proj_dim=16, num_classes=5, learning_rate=0.1,
          warmup_epochs=0, max_epochs=STEPS, total_steps=STEPS, steps_per_epoch=1)
LAYOUTS = {"1x2": (2, (("data", "model"), (1, 2))), "2x2": (4, (("data", "model"), (2, 2)))}


def _group_err(a, b, keys) -> float:
    return (max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in keys)
            / max(float(np.abs(b[k]).max()) for k in keys))


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax_tp(task, state0, steps, scale=1.0):
    mesh = make_mesh(jax.devices()[:4], axis_names=("data", "model"), axis_sizes=(2, 2))
    state = jax.tree.map(jnp.array, state0)
    state = jax.device_put(state, byol_tp_shardings(mesh, state, hidden_dim=HIDDEN))
    metrics = []
    for v1, v2, y in steps:
        state, m = task.train_step(state, jax.device_put(jnp.asarray(v1) * scale, data_sharding(mesh, 4)),
                                   jax.device_put(jnp.asarray(v2), data_sharding(mesh, 4)),
                                   jax.device_put(jnp.asarray(y), data_sharding(mesh, 1)))
        metrics.append({k: float(v) for k, v in m.items()})
    s = jax.device_get(state)
    return {"online": _np(flax_to_state_dict(s.params, s.batch_stats)),
            "target": _np(flax_to_state_dict(s.target_params, s.target_batch_stats))}, metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    jt = JaxBYOLTask(dtype=jnp.float32, **KW)
    s0 = jax.device_get(jax.jit(lambda key: jt.init(key, (2 * B, S, S, 1)))(jax.random.key(0)))
    steps = [(rng.standard_normal((B, S, S, 1)).astype(np.float32),
              rng.standard_normal((B, S, S, 1)).astype(np.float32),
              rng.integers(0, 5, B).astype(np.int32)) for _ in range(STEPS)]
    init = {"online": flax_to_state_dict(s0.params, s0.batch_stats),
            "target": flax_to_state_dict(s0.target_params, s0.target_batch_stats)}
    torch.save({**init, "steps": steps}, d / "in.pt")
    torch.save({**init, "steps": [(v1 * (1 + 1e-6), v2, y) for v1, v2, y in steps]}, d / "spread.pt")
    launches = {name: td.Launch(td.byol_steps, world, str(d / "in.pt"), KW, axes,
                                str(d / f"ckpt_{name}") if name == "1x2" else "")
                for name, (world, axes) in LAYOUTS.items()}
    out = {"jax": _jax_tp(jt, s0, steps), "jax_spread": _jax_tp(jt, s0, steps, 1.0 + 1e-6)[0],
           "one": td.byol_steps(str(d / "in.pt"), KW), "one_spread": td.byol_steps(str(d / "spread.pt"), KW),
           "ckpt": str(d / "ckpt_1x2"), "x": steps[0][0]}
    for name, launch in launches.items():
        out[name] = launch.results()
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tensor_parallel_step_equals_the_replicated_step_and_jax(runs, layout):
    (jstates, jmetrics), jspread = runs["jax"], runs["jax_spread"]
    one, one_spread = runs["one"], runs["one_spread"]
    for res in runs[layout]:
        for step, (m, m1, mj) in enumerate(zip(res["metrics"], one["metrics"], jmetrics)):
            assert m["lr"] == m1["lr"] and m["momentum"] == m1["momentum"]
            for k in ("loss", "probe_loss", "probe_acc"):
                assert m[k] == pytest.approx(m1[k], rel=1e-5 if step == 0 else 1e-3, abs=1e-6), (step, k)
                assert m[k] == pytest.approx(mj[k], rel=1e-4 if step == 0 else 1e-3, abs=1e-6), (step, k)
        for side in ("online", "target"):
            stats = [k for k in one[side] if "running_" in k]
            for group, keys in (("params", [k for k in one[side] if k not in stats]), ("stats", stats)):
                tol = max(1e-5, 3 * _group_err(one_spread[side], one[side], keys))
                err = _group_err(res[side], one[side], keys)
                assert err <= tol, ("one-rank", side, group, err, tol)
                spread = max(_group_err(jspread[side], jstates[side], keys),
                             _group_err(one_spread[side], one[side], keys))
                tol = max(1e-3, 3 * spread)
                err = _group_err(res[side], jstates[side], keys)
                assert err <= tol, ("jax", side, group, err, tol)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_rank_ends_with_the_same_whole_state(runs, layout):
    """Model peers gather the same heads and hold the same encoder (the
    column-parallel input's gradient is summed over the model group); data
    peers hold the same everything."""
    first = runs[layout][0]
    for res in runs[layout][1:]:
        for side in ("online", "target"):
            for k in first[side]:
                assert np.array_equal(res[side][k], first[side][k]), (side, k)
        assert all(np.array_equal(res["momentum"][i], first["momentum"][i]) for i in first["momentum"])


def test_a_tensor_parallel_checkpoint_is_laid_out_as_a_one_card_one(runs):
    ckpt = load_checkpoint(runs["ckpt"])
    one = BYOLTask(dtype=torch.float32, device="cpu", **KW)
    ref = one.state_dict()
    assert {k: tuple(v.shape) for k, v in ckpt["online"].items()} == {k: tuple(v.shape) for k, v in
                                                                       ref["online"].items()}
    assert ({i: tuple(st["momentum_buffer"].shape) for i, st in ckpt["optimizer"]["state"].items()}
            == {i: tuple(p.shape) for i, p in enumerate(one.online.parameters())})
    assert any(shard_dim(k) is not None for k in ckpt["online"])
    one.load_state_dict(ckpt)
    p, z = td.byol_forward(one, torch.from_numpy(runs["x"]))
    rank0 = runs["1x2"][0]
    for got, want in zip((p, z), rank0["forward"][0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # back into a tensor-parallel task: its forward and gathered state are the saved ones
    for a, b in zip(rank0["forward"][1], rank0["forward"][0]):
        np.testing.assert_array_equal(a, b)
    for k, v in ckpt["online"].items():
        np.testing.assert_array_equal(rank0["reloaded"][k], v.numpy())
