"""The JAX package's orbax checkpoints read by the port, on the CPU.

BYOL (2D and volumetric), U-Net, ``UNet3D`` and linear-probe states are
written with the JAX package's own ``core/checkpoint.py::save_checkpoint``
and read back through ``load_checkpoint`` and through the flag of every
port entry point that takes a checkpoint: ``--checkpoint`` of predict,
predict3d, export, export3d and the linear probe, ``--ssl_checkpoint`` of
both segmentation trainers, ``--checkpoint_path`` of ``mis-train-ssl-torch``.

Only weights and BatchNorm statistics cross. The port's f32 forward on the
weights it read is held to the JAX forward on the state that was saved:
1e-4 of the largest output (the tolerance of ``test_torch_unet.py`` and
``test_torch_ssl_eval.py``). An entry point on the orbax directory must
give exactly what it gives on the ``.pt`` converted in memory, since both
hold the same numbers. ``--resume`` on an orbax directory raises by name.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.core.checkpoint import save_checkpoint as jax_save
from medical_image_segmentation_tpu.eval.linear_probe import LinearProbe as JaxLinearProbe
from medical_image_segmentation_tpu.train.byol_task import BYOLTask as JaxBYOLTask
from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask as JaxSeg3DTask
from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask as JaxSegTask
from medical_image_segmentation_tpu_torch import serve
from medical_image_segmentation_tpu_torch.core import checkpoint as tckpt
from medical_image_segmentation_tpu_torch.core.convert import (
    flax_to_state_dict, probe_flax_to_state_dict, unet3d_flax_to_state_dict, unet_flax_to_state_dict,
)
from medical_image_segmentation_tpu_torch.data.nifti import read_nifti, write_nifti
from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter
from medical_image_segmentation_tpu_torch.eval import run_linear_probe
from medical_image_segmentation_tpu_torch.eval.linear_probe import LinearProbe
from medical_image_segmentation_tpu_torch.train import (
    export, export3d, predict, predict3d, train_segmentation, train_segmentation3d, train_ssl,
)
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

torch.set_num_threads(2)


def _bump(tree, by):
    return jax.tree.map(lambda a: a + by, tree)


def _save(d, state, step):
    """``state`` as an orbax checkpoint under ``d``; an earlier step beside
    it, so that a root must resolve to the latest."""
    os.makedirs(os.path.join(str(d), str(step - 1)))
    jax_save(str(d), jax.device_get(state), step)
    return str(d)


@pytest.fixture(scope="module")
def byol(tmp_path_factory):
    """JAX BYOL states whose target and running statistics differ from the
    online network and the init: CIFAR-shaped (3 channels, low-res stem) for
    the probe and the val pass, 1 channel for the U-Net graft."""
    out = {}
    for name, ch, low_res in (("rgb", 3, True), ("gray", 1, False)):
        jt = JaxBYOLTask(arch="resnet18", in_channels=ch, low_res=low_res, hidden_dim=32, proj_dim=16,
                         num_classes=10, dtype=jnp.float32)
        state = jt.init(jax.random.key(1), (2, 32, 32, ch))
        state = state.replace(step=jnp.asarray(7, state.step.dtype), target_params=_bump(state.target_params, 0.01),
                              batch_stats=_bump(state.batch_stats, 0.25))
        out[name] = (jt, state, _save(tmp_path_factory.mktemp(f"byol_{name}"), state, 7))
    yield out
    for _, _, d in out.values():
        shutil.rmtree(d)  # full-size ResNet-18 states with their optimizer


@pytest.fixture(scope="module")
def unet(tmp_path_factory):
    jt = JaxSegTask(arch="resnet18", dtype=jnp.float32)
    state = jt.init(jax.random.key(2), (2, 64, 64, 1))
    state = state.replace(step=jnp.asarray(5, state.step.dtype), batch_stats=_bump(state.batch_stats, 0.25))
    d = _save(tmp_path_factory.mktemp("unet"), state, 5)
    yield jt, state, d
    shutil.rmtree(d)


@pytest.fixture(scope="module")
def unet3d(tmp_path_factory):
    jt = JaxSeg3DTask(features=(4, 8), learning_rate=0.3, warmup_epochs=0, max_epochs=100, min_lr=0.0,
                      dtype=jnp.float32)
    state = jt.init(jax.random.key(3), (1, 8, 16, 16, 1))
    rng = np.random.default_rng(0)
    msk = np.zeros((2, 8, 16, 16, 1), np.float32)
    msk[:, 2:6, 4:12, 4:12] = 1.0
    vol = msk * 0.8 + rng.random(msk.shape).astype(np.float32) * 0.1
    for _ in range(10):  # trained a little, so that masks have both classes
        state, _ = jt.train_step(state, jnp.asarray(vol), jnp.asarray(msk))
    return jt, state, _save(tmp_path_factory.mktemp("unet3d"), state, 10)


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_resolve_picks_the_latest_step_of_either_kind(tmp_path, unet):
    d = unet[2]
    assert tckpt.latest_orbax_step(d) == 5 and tckpt.latest_step(d) is None
    assert tckpt.resolve_checkpoint_path(d) == tckpt.resolve_checkpoint_path(d + "/") == os.path.join(d, "5")
    assert tckpt.resolve_checkpoint_path(os.path.join(d, "5") + "/") == os.path.join(d, "5")
    tckpt.save_checkpoint(str(tmp_path), {"step": 3}, 3)
    os.makedirs(tmp_path / "9")  # a .pt wins where both are present
    assert tckpt.resolve_checkpoint_path(str(tmp_path)) == str(tmp_path / "3.pt")
    year = tmp_path / "2024"  # a digit-named directory of .pt files is a checkpoint directory, not an orbax step
    tckpt.save_checkpoint(str(year), {"step": 4}, 4)
    assert tckpt.resolve_checkpoint_path(str(year)) == str(year / "4.pt")
    assert tckpt.load_checkpoint(str(year)) == {"step": 4}
    assert tckpt.resolve_checkpoint_path(str(tmp_path)) == str(tmp_path / "3.pt")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(SystemExit, match="no checkpoint steps"):
        tckpt.resolve_checkpoint_path(str(tmp_path / "empty"))


def test_byol_state_crosses_with_online_target_and_statistics(byol):
    jt, state, d = byol["rgb"]
    ckpt = tckpt.load_checkpoint(d)
    assert set(ckpt) == {"step", "online", "target"} and ckpt["step"] == 7
    host = jax.device_get(state)
    _assert_same_state(ckpt["online"], flax_to_state_dict(host.params, host.batch_stats))
    _assert_same_state(ckpt["target"], flax_to_state_dict(host.target_params, host.target_batch_stats))
    task = BYOLTask(arch="resnet18", in_channels=3, low_res=True, hidden_dim=32, proj_dim=16, num_classes=10,
                    dtype=torch.float32, device="cpu")
    task.load_state_dict(ckpt)  # no optimizer entry: the optimizer starts fresh
    assert task.step == 7 and not task.optimizer.state
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
    _close(task.embed_step(torch.from_numpy(x)), jt.embed_step(state, jnp.asarray(x)))


def test_probe_state_crosses(tmp_path):
    jp = JaxLinearProbe(feature_dim=32, num_classes=4, lr=1e-2)
    js = jp.init(jax.random.key(0))
    jax_save(str(tmp_path), jax.device_get(js), 2)
    ckpt = tckpt.load_checkpoint(str(tmp_path))
    assert set(ckpt) == {"head"}
    _assert_same_state(ckpt["head"], probe_flax_to_state_dict(jax.device_get(js.params)))
    probe = LinearProbe(32, 4, device="cpu")
    probe.head.load_state_dict(ckpt["head"])
    x = np.random.default_rng(1).standard_normal((8, 32)).astype(np.float32)
    y = np.arange(8, dtype=np.int32) % 4
    want = jp.eval_step(js, jnp.asarray(x), jnp.asarray(y))
    got = probe.eval_step(torch.from_numpy(x), torch.from_numpy(y))
    assert float(got["online_val_loss"]) == pytest.approx(float(want["online_val_loss"]), rel=1e-5)


def test_an_unknown_tree_and_a_missing_orbax_raise_plainly(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="unknown JAX state"):
        tckpt.orbax_to_state({"params": {"mystery": np.zeros(2)}})
    with pytest.raises(KeyError, match="no torch counterpart"):
        tckpt.orbax_to_state({"params": {"encoder": {"mystery": np.zeros(2)}}})
    os.makedirs(tmp_path / "4")
    monkeypatch.setitem(__import__("sys").modules, "orbax.checkpoint", None)
    with pytest.raises(SystemExit, match="orbax-checkpoint package, which is not installed"):
        tckpt.load_checkpoint(str(tmp_path))


@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    d = tmp_path_factory.mktemp("c10")
    rng = np.random.default_rng(0)
    for split, n in (("train", 16), ("val", 16)):
        with StoreWriter(str(d / f"{split}.mis"), channels=3, with_labels=True) as w:
            for i in range(n):
                w.add(rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8), label=i % 10, codec=CODEC_RAW)
    return d


def test_linear_probe_and_single_validation_read_an_orbax_directory(byol, cifar, tmp_path, monkeypatch):
    monkeypatch.setenv("CIFAR10_TRAIN_STORE", str(cifar / "train.mis"))
    monkeypatch.setenv("CIFAR10_VAL_STORE", str(cifar / "val.mis"))
    _, state, d = byol["rgb"]
    host = jax.device_get(state)
    tckpt.save_checkpoint(str(tmp_path / "pt"), {
        "step": 7, "online": flax_to_state_dict(host.params, host.batch_stats),
        "target": flax_to_state_dict(host.target_params, host.target_batch_stats)}, 7)
    common = ["--dataset", "CIFAR10", "--hidden_dim", "32", "--projection_dim", "16", "--batch_size", "8",
              "--device", "cpu"]
    probe = [run_linear_probe.run(["--checkpoint", c, "--epochs", "1", "--lr", "1e-2", *common])
             for c in (d, str(tmp_path / "pt"))]
    assert probe[0] == probe[1] and np.isfinite(probe[0]["online_val_loss"])
    val = [train_ssl.run(["--run_single_validation", "--checkpoint_path", c, "--fp32", "--num_workers", "1",
                          "--log_dir", str(tmp_path / "logs"), *common]).val for c in (os.path.join(d, "7"), d)]
    assert val[0] == val[1] and set(val[0]) == {"val/loss", "val/acc@1", "val/acc@5"}
    shutil.rmtree(tmp_path / "pt")


def test_ssl_checkpoint_of_the_2d_trainer_grafts_an_orbax_backbone(byol, tmp_path):
    _, state, d = byol["gray"]
    rng = np.random.default_rng(0)
    for split in ("train", "val", "test"):
        with StoreWriter(str(tmp_path / f"seg_{split}_images.mis"), channels=1) as wi, \
                StoreWriter(str(tmp_path / f"seg_{split}_masks.mis"), channels=1) as wm:
            for _ in range(4):
                wi.add(rng.integers(0, 256, size=(64, 64, 1), dtype=np.uint8), codec=CODEC_RAW)
                wm.add((rng.random((64, 64, 1)) < 0.3).astype(np.uint8), codec=CODEC_RAW)
    argv = ["--device", "cpu", "--images_dir", str(tmp_path), "--masks_dir", str(tmp_path), "--seg_store_prefix",
            str(tmp_path / "seg"), "--batch_size", "4", "--image_size", "64", "--max_epochs", "1",
            "--limit_steps_per_epoch", "1", "--warmup_epochs", "0", "--num_workers", "1", "--fp32",
            "--skip_hbm_check", "--force_hbm", "--log_dir", str(tmp_path / "logs"),
            "--checkpoint_dir", str(tmp_path / "ckpt")]
    run = train_segmentation.run([*argv, "--ssl_checkpoint", d])
    host = jax.device_get(state)
    online = flax_to_state_dict(host.params, host.batch_stats)
    enc = [k for k in run.start_state if k.startswith("encoder.")]
    assert enc and all(torch.equal(run.start_state[k], online["encoder.backbone." + k[len("encoder."):]])
                       for k in enc)
    assert run.task.step == 1
    with pytest.raises(SystemExit, match="--resume.*orbax checkpoints of the JAX package.*optimizer"):
        train_segmentation.run([*argv[:-1], d, "--resume"])
    shutil.rmtree(tmp_path / "ckpt")


def test_ssl_checkpoint_of_the_3d_trainer_grafts_an_orbax_backbone(tmp_path):
    jt = JaxBYOLTask(hidden_dim=32, proj_dim=16, volumetric=True, features3d=(4, 8), in_channels=1,
                     dtype=jnp.float32)
    state = jt.init(jax.random.key(4), (2, 8, 16, 16, 1))
    d = _save(tmp_path / "ssl3d", state, 3)
    root = tmp_path / "task"
    (root / "imagesTr").mkdir(parents=True)
    (root / "labelsTr").mkdir()
    rng = np.random.default_rng(0)
    names = [f"case_{i}" for i in range(4)]
    for name in names:
        img = rng.normal(-200, 60, (18, 18, 11))
        write_nifti(str(root / "imagesTr" / f"{name}.nii.gz"), img.astype(np.int16))
        write_nifti(str(root / "labelsTr" / f"{name}.nii.gz"), (img > -180).astype(np.uint8))
    (root / "split.json").write_text(json.dumps({"train": names[:2], "val": names[2:3], "test": names[3:]}))
    argv = ["--device", "cpu", "--fp32", "--images_dir", str(root / "imagesTr"), "--masks_dir",
            str(root / "labelsTr"), "--split_file", str(root / "split.json"), "--volume_size", "12", "20", "20",
            "--crop_size", "8", "16", "16", "--features", "4", "8", "--batch_size", "2", "--max_epochs", "1",
            "--warmup_epochs", "0", "--log_dir", str(tmp_path / "logs"), "--checkpoint_dir"]
    run = train_segmentation3d.run([*argv, str(tmp_path / "ckpt"), "--ssl_checkpoint", d])
    host = jax.device_get(state)
    online = flax_to_state_dict(host.params, host.batch_stats)
    grafted = [k for k in run.start_state if k.startswith(("enc", "down"))]
    assert grafted and all(torch.equal(run.start_state[k], online["encoder.backbone." + k]) for k in grafted)
    with pytest.raises(SystemExit, match="--resume.*orbax checkpoints of the JAX package"):
        train_segmentation3d.run([*argv, d, "--resume"])


def test_unet_checkpoint_serves_and_exports_from_an_orbax_directory(unet, tmp_path, capfd):
    jt, state, d = unet
    host = jax.device_get(state)
    ckpt = tckpt.load_checkpoint(d)
    assert set(ckpt) == {"step", "model"} and ckpt["step"] == 5
    _assert_same_state(ckpt["model"], unet_flax_to_state_dict(host.params, host.batch_stats))
    task = SegmentationTask(dtype=torch.float32, device="cpu")
    task.load_state_dict(ckpt)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 1)).astype(np.float32)
    want = jt.model.apply({"params": state.params, "batch_stats": state.batch_stats}, jnp.asarray(x), train=False)
    _close(task.logits(torch.from_numpy(x)), want)

    tckpt.save_checkpoint(str(tmp_path / "converted"), {"step": 5, "model": ckpt["model"]}, 5)
    rng = np.random.default_rng(1)
    store = str(tmp_path / "s.mis")
    with StoreWriter(store, channels=1) as w:
        for _ in range(5):
            w.add(rng.integers(0, 256, size=(64, 64, 1), dtype=np.uint8), codec=CODEC_RAW)
    common = ["--dataset", "DECATHLON_HEART", "--image_size", "64", "--fp32", "--device", "cpu"]
    serve_argv = ["--image_store", store, "--batch_size", "4", "--num_workers", "1"]
    for name, c in (("orbax", d), ("pt", str(tmp_path / "converted"))):
        predict.run(["--checkpoint", c, "--output_dir", str(tmp_path / name), *common, *serve_argv])
    assert "restored " + os.path.join(d, "5") + " (step 5)" in capfd.readouterr().err
    summary = export.run(["--checkpoint", d, "--output", str(tmp_path / "m.misx"), "--batch_sizes", "4", *common])
    assert summary["checkpoint_step"] == 5 and summary["platforms"] == ["cpu"]
    predict.run(["--exported", str(tmp_path / "m.misx"), "--output_dir", str(tmp_path / "exported"),
                 "--device", "cpu", *serve_argv])
    names = sorted(os.listdir(tmp_path / "pt"))
    assert len(names) == 5
    for n in names:
        want = (tmp_path / "pt" / n).read_bytes()
        assert (tmp_path / "orbax" / n).read_bytes() == want and (tmp_path / "exported" / n).read_bytes() == want, n
    shutil.rmtree(tmp_path / "converted")


def test_unet3d_checkpoint_serves_and_exports_from_an_orbax_directory(unet3d, tmp_path):
    jt, state, d = unet3d
    host = jax.device_get(state)
    ckpt = tckpt.load_checkpoint(os.path.join(d, "10"))
    assert ckpt["step"] == 10
    _assert_same_state(ckpt["model"], unet3d_flax_to_state_dict(host.params, host.batch_stats))
    task = Segmentation3DTask(features=(4, 8), dtype=torch.float32, device="cpu")
    task.load_state_dict(ckpt)
    x = np.random.default_rng(0).random((2, 8, 16, 16, 1)).astype(np.float32)
    _close(task.logits(torch.from_numpy(x)), jt.model.apply({"params": state.params}, jnp.asarray(x), train=False))

    tckpt.save_checkpoint(str(tmp_path / "converted"), {"step": 10, "model": ckpt["model"]}, 10)
    vols = tmp_path / "vols"
    vols.mkdir()
    big = np.random.default_rng(1).random((20, 18, 10)).astype(np.float32) * 0.1
    big[6:14, 5:13, 2:7] += 0.8
    write_nifti(str(vols / "big.nii.gz"), big)
    common = ["--features", "4", "8", "--window", "8", "16", "16", "--mean", "0.0", "--std", "1.0", "--fp32",
              "--device", "cpu"]
    for name, c in (("orbax", d), ("pt", str(tmp_path / "converted"))):
        predict3d.run(["--checkpoint", c, "--images_dir", str(vols), "--output_dir", str(tmp_path / name), *common])
    summary = export3d.run(["--checkpoint", d, "--output", str(tmp_path / "w.misx"), "--batch_windows", "4", *common])
    assert summary["checkpoint_step"] == 10 and summary["window"] == [8, 16, 16]
    predict3d.run(["--exported", str(tmp_path / "w.misx"), "--images_dir", str(vols), "--device", "cpu",
                   "--output_dir", str(tmp_path / "exported")])
    want = np.asarray(read_nifti(str(tmp_path / "pt" / "big_mask.nii.gz")).data)
    assert 0.01 < want.mean() < 0.99, "the case must have both classes"
    for name in ("orbax", "exported"):
        np.testing.assert_array_equal(np.asarray(read_nifti(str(tmp_path / name / "big_mask.nii.gz")).data), want)
    assert serve.load_window_predictor(str(tmp_path / "w.misx"), device="cpu")[0]["checkpoint_step"] == 10
