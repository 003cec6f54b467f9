"""Depth sharding of the PyTorch port (``--space_shards``) in 2 and 4 gloo
ranks on the CPU: ``parallel/spatial.py::halo_exchange``, the sharded
layers of ``models/unet3d.py``, ``UNet3D`` and ``Segmentation3DTask`` on a
``("data", "space")`` mesh, against one process on the whole volume and the
JAX step sharded with ``spatial_sharding(mesh, ndim=5)`` over the
conftest's 8 CPU devices as (4, 2).

Every multi-rank case runs in one launch of 4 ranks and one of 2; this
process computes the references meanwhile.

Tolerances.
- The halo exchange moves values and adds zeros: its output and its
  input's gradient equal the whole tensor's slices to the bit (f64), and
  the dot-product test <halo(x), y> = <x, haloᵀ(y)> holds to 1e-12
  relative.
- The sharded convolutions, GroupNorm and the ``UNet3D`` forward and
  gradients are f32 sums taken in another order: atol 1e-5 (relative to
  the largest magnitude, 1e-5) against the whole volume.
- Steps against the one-process step and the JAX step: the measure of
  ``test_torch_ddp.py``: parameters per group by max|a-b| over max|b|,
  within three times the reference's own spread under a 1e-6 change of the
  input, and never looser than 1e-5 is needed against one process and
  1e-3 against JAX; step-1 losses to 1e-5 relative (one process) and 1e-4
  (JAX). Ranks end equal to the bit. ``--remat`` gives the same step to
  1e-6.
"""

import numpy as np
import pytest
import torch

import _torch_dist as td
from medical_image_segmentation_tpu_torch.core import hbm
from medical_image_segmentation_tpu_torch.core.convert import unet3d_flax_to_state_dict
from medical_image_segmentation_tpu_torch.ops.augment3d import sample_volume_draws, segmentation_augment_3d
from medical_image_segmentation_tpu_torch.parallel import mesh as pm

torch.set_num_threads(2)

B, CROP, STEPS = 4, (16, 16, 16), 2  # at crop depth 8 the JAX step on the (4, 2) mesh is off (ROADMAP queue 3)
FEATURES = (4, 8, 16)
SEG3D_KW = dict(features=FEATURES, learning_rate=0.5, warmup_epochs=0, max_epochs=STEPS, min_lr=0.01,
                steps_per_epoch=1)
HALO_SHAPE = (2, 3, 8, 4, 5)
UNET_SHAPE = (2, 16, 16, 16, 1)


def _spheres(rng, b, dims):
    grid = np.mgrid[tuple(slice(0, d) for d in dims)]
    masks = np.zeros((b, *dims, 1), np.float32)
    for i in range(b):
        c = [rng.integers(d // 4, 3 * d // 4) for d in dims]
        r = rng.integers(4, 7) if i < b // 2 else 1
        masks[i, ..., 0] = sum((g - ci) ** 2 for g, ci in zip(grid, c)) <= r * r
    return masks


def _seg_batches(rng):
    out = []
    for _ in range(STEPS):
        m = _spheres(rng, B, CROP)
        out.append(((rng.standard_normal((B, *CROP, 1)) * 0.5 + 1.5 * m - 0.5).astype(np.float32), m))
    return out


def _trainer_argv(*extra):
    return ["--device", "cpu", "--images_dir", "unused", "--masks_dir", "unused", "--features", "4", "8", "16",
            *extra]


FOUR_REFUSALS = [_trainer_argv("--space_shards", "2", "--batch_size", "3")]
TWO_REFUSALS = [_trainer_argv("--space_shards", "4"),
                _trainer_argv("--space_shards", "2", "--crop_size", "9", "16", "16"),
                _trainer_argv("--space_shards", "2", "--crop_size", "12", "16", "16"),
                _trainer_argv("--space_shards", "2", "--device_cache")]


def _jax_init(task, shape):
    import jax

    return jax.device_get(jax.jit(lambda key: task.init(key, shape))(jax.random.key(0)))


def _jax_space_steps(task, state0, steps, scale=1.0):
    """The JAX steps with the volumes sharded over batch and depth on a
    (data, space) = (4, 2) mesh of the CPU devices."""
    import jax
    import jax.numpy as jnp

    from medical_image_segmentation_tpu.parallel import make_mesh, replicated
    from medical_image_segmentation_tpu.parallel.mesh import spatial_sharding

    mesh = make_mesh(axis_names=("data", "space"), axis_sizes=(4, 2))
    state = jax.device_put(jax.tree.map(jnp.array, state0), replicated(mesh))
    sharding = spatial_sharding(mesh, ndim=5)
    metrics = []
    for x, m in steps:
        state, out = task.train_step(state, jax.device_put(jnp.asarray(x * scale), sharding),
                                     jax.device_put(jnp.asarray(m), sharding))
        metrics.append({k: float(v) for k, v in out.items()})
    return jax.device_get(state), metrics


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The ranks' results of every case and the references."""
    import jax.numpy as jnp

    from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask as JaxSeg3DTask

    d = tmp_path_factory.mktemp("space")
    rng = np.random.default_rng(0)
    out = {"seg": {}}
    steps = _seg_batches(rng)
    jax_tasks = {}
    for norm in ("group", "batch"):
        jt = JaxSeg3DTask(norm=norm, dtype=jnp.float32, **SEG3D_KW)
        s0 = _jax_init(jt, (1, *CROP, 1))
        init = unet3d_flax_to_state_dict(s0.params, s0.batch_stats)
        torch.save({"model": init, "steps": steps}, d / f"{norm}.pt")
        torch.save({"model": init, "steps": [(x * (1 + 1e-6), m) for x, m in steps]}, d / f"{norm}_spread.pt")
        jax_tasks[norm] = (jt, s0)
    fractions = [float(np.mean([m[half].mean() for _, m in steps])) for half in (slice(0, B // 2), slice(B // 2, B))]

    four = [(td.halo_case, (4, 1, 1, (2, 3, 16, 4, 5), 3)), (td.halo_case, (2, 1, 0, HALO_SHAPE, 4)),
            (td.space_layers_case, (4, 5)), (td.unet3d_space_case, (4, UNET_SHAPE, FEATURES, 6)),
            (td.seg_steps, (str(d / "group.pt"), dict(norm="group", **SEG3D_KW), True, False, 2)),
            (td.seg_steps, (str(d / "batch.pt"), dict(norm="batch", **SEG3D_KW), True, False, 2)),
            (td.seg_steps, (str(d / "group.pt"), dict(norm="group", remat=True, **SEG3D_KW), True, False, 2)),
            *[(td.trainer_refusal, (argv,)) for argv in FOUR_REFUSALS]]
    two = [(td.halo_case, (2, 1, 1, HALO_SHAPE, 1)), (td.halo_case, (2, 1, 0, HALO_SHAPE, 2)),
           (td.halo_case, (2, 2, 1, HALO_SHAPE, 3)), (td.space_layers_case, (2, 5)),
           (td.unet3d_space_case, (2, UNET_SHAPE, FEATURES, 6)),
           (td.unet3d_space_case, (2, UNET_SHAPE, FEATURES, 6, "batch")),
           (td.seg_steps, (str(d / "group.pt"), dict(norm="group", **SEG3D_KW), True, False, 2)),
           (td.seg_steps, (str(d / "group.pt"), dict(norm="group", remat=True, **SEG3D_KW), True, False, 2)),
           *[(td.trainer_refusal, (argv,)) for argv in TWO_REFUSALS]]
    launches = {4: td.Launch(td.run_all, 4, four), 2: td.Launch(td.run_all, 2, two)}

    # the references, while the ranks run
    out["unet"] = {norm: td.unet3d_space_case(1, UNET_SHAPE, FEATURES, 6, norm) for norm in ("group", "batch")}
    for norm, (jt, s0) in jax_tasks.items():
        res = out["seg"][norm] = {"fractions": fractions}
        kw = dict(norm=norm, **SEG3D_KW)
        res["one"] = td.seg_steps(str(d / f"{norm}.pt"), kw, True)
        res["one_spread"] = td.seg_steps(str(d / f"{norm}_spread.pt"), kw, True)
        for key, scale in (("jax", 1.0), ("jax_spread", 1.0 + 1e-6)):
            js, jm = _jax_space_steps(jt, s0, steps, scale)
            res[key] = ({k: v.numpy() for k, v in unet3d_flax_to_state_dict(js.params, js.batch_stats).items()}, jm)

    out["four"] = launches[4].results()
    out["two"] = launches[2].results()
    return out


# ------------------------------------------------------------- halo exchange


def _halo_expected(shape, seed, space, rank, left, right):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    per = shape[2] // space
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, left, right))
    return x, padded[:, :, rank * per:rank * per + left + per + right]


@pytest.mark.parametrize("launch,index,space,left,right,shape,seed", [
    ("two", 0, 2, 1, 1, HALO_SHAPE, 1), ("two", 1, 2, 1, 0, HALO_SHAPE, 2), ("two", 2, 2, 2, 1, HALO_SHAPE, 3),
    ("four", 0, 4, 1, 1, (2, 3, 16, 4, 5), 3), ("four", 1, 2, 1, 0, HALO_SHAPE, 4),
], ids=["2r-1-1", "2r-1-0", "2r-2-1", "4r-1-1", "4r-s2-1-0"])
def test_halo_exchange_forward_and_its_adjoint(cases, launch, index, space, left, right, shape, seed):
    ranks = [r[index] for r in cases[launch]]
    x, _ = _halo_expected(shape, seed, space, 0, left, right)
    xg = x.clone().requires_grad_()
    padded = torch.nn.functional.pad(xg, (0, 0, 0, 0, left, right))
    per = shape[2] // space
    total = 0
    for rank, res in enumerate(ranks):
        s = rank % space  # the space index: ranks (d, s) row-major
        want = padded[:, :, s * per:s * per + left + per + right]
        assert np.array_equal(res["out"], want.detach().numpy()), rank
        assert res["contiguous_channels_last"]
        if rank < space:  # the first space group: the whole tensor's gradient
            total = total + (want * torch.from_numpy(res["cotangent"])).sum()
        lhs, rhs = res["dots"]
        assert rhs == pytest.approx(lhs, rel=1e-12), rank
    total.backward()
    for rank in range(space):
        assert np.array_equal(ranks[rank]["grad"], xg.grad[:, :, rank * per:(rank + 1) * per].numpy()), rank


# ------------------------------------------------------------------- layers


def _close(a, b, tol=1e-5):
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= tol * scale, float(np.abs(a - b).max())


@pytest.mark.parametrize("launch,index,space", [("two", 3, 2), ("four", 2, 4)], ids=["S2", "S4"])
@pytest.mark.parametrize("layer", ["conv1", "conv2", "norm"])
def test_sharded_layers_equal_the_whole_volume(cases, launch, index, space, layer):
    """Stride-1 and stride-2 convolutions and GroupNorm on slabs: outputs,
    the slab's gradient, and the parameters' gradients summed over the
    ranks, against the whole volume with the ranks' cotangents stacked."""
    from medical_image_segmentation_tpu_torch.models import unet3d

    ranks = [r[index][layer] for r in cases[launch]]
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 6, 8 * space, 6, 5), generator=gen)
    conv1, conv2 = unet3d._conv3(6, 4), unet3d._conv3(6, 6, stride=2)
    norm = unet3d.GroupNorm(3, 6)
    for m in (conv1, conv2, norm):
        for p in m.parameters():
            p.data.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    fn = {"conv1": conv1, "conv2": conv2, "norm": norm}[layer]
    xg = x.clone().requires_grad_()
    y = fn(xg)
    assert np.concatenate([r["y"] for r in ranks], axis=2).shape == tuple(y.shape)
    _close(np.concatenate([r["y"] for r in ranks], axis=2), y.detach().numpy())
    (y * torch.from_numpy(np.concatenate([r["cotangent"] for r in ranks], axis=2))).sum().backward()
    _close(np.concatenate([r["grad"] for r in ranks], axis=2), xg.grad.numpy())
    for k, p in fn.named_parameters():
        _close(sum(r["params"][f"{layer}.{k}"] for r in ranks), p.grad.numpy())


@pytest.mark.parametrize("launch,index,space,norm", [("two", 4, 2, "group"), ("two", 5, 2, "batch"),
                                                     ("four", 3, 4, "group")],
                         ids=["S2-group", "S2-batch", "S4-group"])
def test_unet3d_forward_and_gradients_on_slabs_equal_one_process(cases, launch, index, space, norm):
    one = cases["unet"][norm]
    ranks = [r[index] for r in cases[launch]]
    _close(np.concatenate([r["y"] for r in ranks], axis=1), one["y"])
    _close(np.concatenate([r["grad"] for r in ranks], axis=1), one["grad"])
    for k, g in one["params"].items():
        _close(sum(r["params"][k] for r in ranks), g)


# -------------------------------------------------------------------- steps


def _group_err(a, b, keys) -> float:
    return (max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in keys)
            / max(float(np.abs(b[k]).max()) for k in keys))


def _groups(sd):
    stats = [k for k in sd if "running_" in k]
    return {"params": [k for k in sd if k not in stats], "stats": stats}


@pytest.mark.parametrize("launch,index,norm", [("four", 4, "group"), ("four", 5, "batch"), ("two", 6, "group")],
                         ids=["2x2-group", "2x2-batch", "1x2-group"])
def test_a_step_on_a_data_space_mesh_equals_one_process_and_jax(cases, launch, index, norm):
    c = cases["seg"][norm]
    one, one_spread = c["one"]["model"], c["one_spread"]["model"]
    jstate, jmetrics = c["jax"]
    jspread = c["jax_spread"][0]
    for rank, res in enumerate(r[index] for r in cases[launch]):
        for step, (m, m1, ms, mj) in enumerate(zip(res["metrics"], c["one"]["metrics"], c["one_spread"]["metrics"],
                                                   jmetrics)):
            rel = max(1e-5 if step == 0 else 1e-3, 3 * abs(ms["train/loss"] - m1["train/loss"]) / m1["train/loss"])
            assert m["lr"] == m1["lr"] and m["train/loss"] == pytest.approx(m1["train/loss"], rel=rel), (step, m, m1)
            assert m["train/loss"] == pytest.approx(mj["train/loss"], rel=1e-4 if step == 0 else 1e-3), (step, mj)
        for group, keys in _groups(one).items():
            if not keys:
                continue
            tol = max(1e-5, 3 * _group_err(one_spread, one, keys))
            err = _group_err(res["model"], one, keys)
            assert err <= tol, ("one process", rank, group, err, tol)
            assert all(k in jstate for k in keys)
            tol = max(1e-3, 3 * max(_group_err(jspread, jstate, keys), _group_err(one_spread, one, keys)))
            err = _group_err(res["model"], jstate, keys)
            assert err <= tol, ("jax", rank, group, err, tol)
        for k in ("loss", "dice", "iou"):
            assert res["eval"][k] == pytest.approx(c["one"]["eval"][k], rel=1e-5, abs=1e-6), k
    assert c["fractions"][0] > 20 * c["fractions"][1]  # the data shards hold very different mask fractions


@pytest.mark.parametrize("launch,index", [("four", 4), ("four", 5), ("four", 6), ("two", 6), ("two", 7)],
                         ids=["2x2-group", "2x2-batch", "2x2-remat", "1x2-group", "1x2-remat"])
def test_the_ranks_end_bit_equal(cases, launch, index):
    ranks = [r[index] for r in cases[launch]]
    for res in ranks[1:]:
        assert res["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["model"].items():
            assert np.array_equal(res["model"][k], v), k


@pytest.mark.parametrize("launch,index,plain", [("four", 6, 4), ("two", 7, 6)], ids=["2x2", "1x2"])
def test_remat_reruns_the_collectives_in_order_and_gives_the_same_step(cases, launch, index, plain):
    """Under ``--remat`` the checkpointed blocks re-run their halo
    exchanges and GroupNorm sums during the backward, in the same order on
    every rank (a rank out of order would hang the launch or mix slices):
    the step equals the one without remat on the same mesh to 1e-6."""
    plain = cases[launch][0][plain]
    for res in (r[index] for r in cases[launch]):
        for m, m0 in zip(res["metrics"], plain["metrics"]):
            assert m["train/loss"] == pytest.approx(m0["train/loss"], rel=1e-6)
        for k, v in plain["model"].items():
            np.testing.assert_allclose(res["model"][k], v, rtol=0, atol=1e-6 * max(1.0, float(np.abs(v).max())))


# ---------------------------------------------------------------- refusals


@pytest.mark.parametrize("launch,index,message", [
    ("four", 7, "--batch_size 3 must be divisible by the data shards 2"),
    ("two", 8, "--space_shards 4 must divide the device count 2"),
    ("two", 9, "--crop_size depth must be divisible by --space_shards"),
    ("two", 10, "--crop_size depth 12 must be divisible by --space_shards 2 x 4"),
    ("two", 11, "--device_cache is single-process only"),
], ids=["batch", "world", "crop", "levels", "device_cache"])
def test_the_trainer_refuses_what_cannot_shard(cases, launch, index, message):
    assert all(message in r[index] for r in cases[launch]), [r[index] for r in cases[launch]]


def test_the_jax_refusal_texts_are_the_port_s():
    import inspect

    from medical_image_segmentation_tpu.train import train_segmentation3d as jax_trainer

    src = inspect.getsource(jax_trainer.main)
    for text in ("must divide the device count", "--crop_size depth must be divisible by --space_shards",
                 "must be divisible by the data shards"):
        assert text in src


def test_one_process_refuses_space_shards():
    with pytest.raises(SystemExit, match="--space_shards 2 must divide the device count 1"):
        from medical_image_segmentation_tpu_torch.train import train_segmentation3d

        train_segmentation3d.run(_trainer_argv("--space_shards", "2"))


def test_the_memory_guard_names_space_shards_as_the_jax_text_does():
    from medical_image_segmentation_tpu.core import hbm as jhbm

    with pytest.raises(SystemExit) as ours:
        hbm.check_hbm({"projected_peak": 2, "capacity": 1, "oversubscribed": True}, label="seg3d")
    with pytest.raises(SystemExit) as theirs:
        jhbm.check_hbm({"projected_peak": 2, "arguments": 0, "outputs": 0, "temp": 0, "aliased": 0, "capacity": 1,
                        "oversubscribed": True}, label="seg3d")
    assert "shard wider (--space_shards)" in str(ours.value) and "shard wider (--space_shards)" in str(theirs.value)


# ----------------------------------------------------- mesh and augmentation


def test_depth_slabs_tile_the_depth_in_space_order():
    class FakeMesh:
        def __init__(self, i, n):
            self.i, self.n = i, n

        def size(self, axis):
            return self.n if axis == "space" else 1

        def index(self, axis):
            return self.i if axis == "space" else 0

    assert [pm.depth_slab(FakeMesh(i, 4), 32) for i in range(4)] == [slice(0, 8), slice(8, 16), slice(16, 24),
                                                                     slice(24, 32)]
    assert pm.depth_slab(None, 12) == slice(0, 12)
    with pytest.raises(ValueError, match="depth 30 does not divide the 4 space ranks"):
        pm.depth_slab(FakeMesh(0, 4), 30)


@pytest.mark.parametrize("train", [True, False])
def test_a_rank_s_augmented_slab_is_the_whole_pipeline_s_slab(train):
    """Rows of the global draws, then the depth slab: equal to the bit to
    the whole batch's augmentation cut to the rank's rows and slab, with
    flipped and unflipped depths in the batch."""
    rng = np.random.default_rng(3)
    vols = torch.from_numpy(rng.random((4, 12, 20, 18, 1)).astype(np.float32))
    masks = torch.from_numpy((rng.random((4, 12, 20, 18, 1)) > 0.6).astype(np.float32))
    crop = (8, 16, 16)
    draws = sample_volume_draws(torch.Generator().manual_seed(9), 4, vols.shape[1:4], crop)
    assert draws["flips"][:, 0].any() and not draws["flips"][:, 0].all()
    whole = segmentation_augment_3d(torch.Generator().manual_seed(9), vols, masks, out_size=crop, train=train,
                                    dtype=torch.float32, hu_windows=((0.5, 0.8), (0.3, 0.4)))
    for data in range(2):
        for space in range(4):
            slab = slice(2 * space, 2 * space + 2)
            rows = slice(2 * data, 2 * data + 2)
            got = segmentation_augment_3d(torch.Generator().manual_seed(9), vols[rows], masks[rows], out_size=crop,
                                          train=train, dtype=torch.float32, hu_windows=((0.5, 0.8), (0.3, 0.4)),
                                          shard=(data, 2), depth=slab)
            for g, w in zip(got, whole):
                assert torch.equal(g, w[rows][:, slab]), (data, space)


def test_make_mesh_defaults_to_the_card_of_an_nccl_style_layout(monkeypatch):
    """Without a group, a mesh's device is the launch's card
    (``rank_device``): LOCAL_RANK modulo the cards. No group is needed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for k, v in {"RANK": "6", "WORLD_SIZE": "8", "LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    assert pm.make_mesh().device == torch.device("cuda", 2)
    assert pm.make_mesh(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        pm.make_mesh()
