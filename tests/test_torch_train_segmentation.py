"""The port's ``mis-train-segmentation-torch`` entry point on the CPU: 64²
paired raw stores and a PNG directory, the BYOL→U-Net handoff from a port
BYOL ``.pt``, the checkpoint cadence, SIGTERM, and the refused flags."""

import csv
import glob
import math
import os
import signal

import cv2
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.data import datamodules as jdm
from medical_image_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from medical_image_segmentation_tpu_torch.data import datamodules as tdm
from medical_image_segmentation_tpu_torch.data.device_feed import device_arrays
from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter
from medical_image_segmentation_tpu_torch.ops.augment import segmentation_augment
from medical_image_segmentation_tpu_torch.train import train_segmentation
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

torch.set_num_threads(2)


def _slices(rng, n, h, w):
    """(uint8 image, 0/1 uint8 mask) pairs: a bright disk on noise."""
    yy, xx = np.mgrid[:h, :w]
    for _ in range(n):
        cy, cx = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4, 3 * w // 4)
        r = rng.integers(min(h, w) // 8, min(h, w) // 4)
        m = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8)
        yield np.clip(rng.normal(80, 20, (h, w)) + 100 * m, 0, 255).astype(np.uint8), m


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Paired raw 64² stores: 16 train, 8 val, 8 test slices."""
    d = tmp_path_factory.mktemp("stores")
    rng = np.random.default_rng(0)
    for split, n in (("train", 16), ("val", 8), ("test", 8)):
        with StoreWriter(str(d / f"seg_{split}_images.mis"), channels=1) as wi, \
                StoreWriter(str(d / f"seg_{split}_masks.mis"), channels=1) as wm:
            for img, m in _slices(rng, n, 64, 64):
                wi.add(img[..., None], codec=CODEC_RAW)
                wm.add(m[..., None], codec=CODEC_RAW)
    return str(d / "seg")


@pytest.fixture(scope="module")
def byol_ckpt(tmp_path_factory):
    """A port BYOL checkpoint whose target differs from its online encoder,
    so a graft from the wrong side would show."""
    task = BYOLTask(arch="resnet18", in_channels=1, hidden_dim=32, proj_dim=16)
    task.init(5)
    with torch.no_grad():
        for p in task.target.parameters():
            p.add_(1.0)
    d = tmp_path_factory.mktemp("ssl")
    save_checkpoint(str(d), task.state_dict(), 3)
    return str(d), task.online.state_dict(), task.target.state_dict()


def _argv(tmp_path, stores, *extra):
    return ["--device", "cpu", "--images_dir", str(tmp_path), "--masks_dir", str(tmp_path),
            "--seg_store_prefix", stores, "--batch_size", "4", "--image_size", "64", "--max_epochs", "3",
            "--limit_steps_per_epoch", "2", "--warmup_epochs", "0", "--num_workers", "2", "--fp32",
            "--log_dir", str(tmp_path / "logs"), "--checkpoint_dir", str(tmp_path / "ckpt"), *extra]


def _steps(ckpt_dir):
    return sorted(int(os.path.basename(p)[:-3]) for p in glob.glob(os.path.join(ckpt_dir, "*.pt")))


def test_trains_from_the_byol_online_backbone(tmp_path, stores, byol_ckpt):
    ssl_dir, online, target = byol_ckpt
    result = train_segmentation.run(_argv(tmp_path, stores, "--ssl_checkpoint", ssl_dir,
                                          "--skip_hbm_check", "--force_hbm"))
    start = result.start_state
    enc = [k for k in start if k.startswith("encoder.")]
    assert enc and all(torch.equal(start[k], online["encoder.backbone." + k[len("encoder."):]]) for k in enc)
    assert not torch.equal(start["encoder.conv1.weight"], target["backbone.conv1.weight"])

    task = result.task
    assert task.step == 6 and [e["steps"] for e in result.epochs] == [2, 2, 2]
    assert all(math.isfinite(e["loss"]) for e in result.epochs)
    still = [k for k, p in task.model.named_parameters() if torch.equal(p.detach(), start[k])]
    assert not still, still
    for split, metrics in (("val", result.val), ("test", result.test)):
        assert set(metrics) == {f"{split}/loss", f"{split}/dice", f"{split}/iou"}
        assert all(0.0 <= v <= 1.0 for v in metrics.values()), metrics
    assert result.checkpoint == str(tmp_path / "ckpt" / "6.pt") and not result.stopped
    saved = torch.load(result.checkpoint, weights_only=True)
    assert saved["step"] == 6 and set(saved) == {"step", "model", "optimizer"}
    (metrics_csv,) = glob.glob(str(tmp_path / "logs" / "**" / "metrics.csv"), recursive=True)
    with open(metrics_csv) as f:
        rows = list(csv.DictReader(f))
    assert {"train/loss", "lr", "val/dice", "test/iou"} <= set(rows[0])


@pytest.mark.parametrize("every,expected", [(1, [2, 4, 6]), (2, [4, 6]), (0, [6])])
def test_checkpoint_cadence_skips_the_last_epoch(tmp_path, stores, every, expected):
    train_segmentation.run(_argv(tmp_path, stores, "--checkpoint_every_epochs", str(every)))
    assert _steps(str(tmp_path / "ckpt")) == expected


def test_eval_metrics_are_the_mean_of_per_batch_metrics(tmp_path, stores):
    result = train_segmentation.run(_argv(tmp_path, stores, "--max_epochs", "1"))
    dm = tdm.get_datamodule("DECATHLON_LIVER")(store_prefix=stores, image_size=64)
    loader = dm.loader("test", 4)
    per_batch = []
    try:
        for imgs, msks in device_arrays(loader, "cpu"):
            x, y = segmentation_augment(None, imgs, msks, (64, 64), dm.mean, dm.std, train=False,
                                        dtype=torch.float32)
            per_batch.append({k: float(v) for k, v in result.task.eval_step(x, y).items()})
    finally:
        loader.close()
    assert len(per_batch) == 2
    for k in ("loss", "dice", "iou"):
        assert result.test[f"test/{k}"] == pytest.approx(np.mean([m[k] for m in per_batch]), rel=1e-6)


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """12 slice pairs of 72×88 as PNGs (no split file: every split sees all)."""
    d = tmp_path_factory.mktemp("png")
    (d / "images").mkdir()
    (d / "masks").mkdir()
    for i, (img, m) in enumerate(_slices(np.random.default_rng(1), 12, 72, 88)):
        cv2.imwrite(str(d / "images" / f"liver_{i}_0.png"), img)
        cv2.imwrite(str(d / "masks" / f"liver_{i}_0.png"), m * 255)
    return d


def test_png_dir_with_windows_grid_and_full_res_test(tmp_path, png_dir):
    grid = str(tmp_path / "grid.png")
    argv = ["--device", "cpu", "--images_dir", str(png_dir / "images"), "--masks_dir", str(png_dir / "masks"),
            "--batch_size", "4", "--image_size", "64", "--max_epochs", "1", "--limit_steps_per_epoch", "2",
            "--warmup_epochs", "0", "--num_workers", "2", "--fp32", "--hu_windows", "96:160,40:80",
            "--loss", "dice_ce", "--full_res_window", "64", "--predict_grid", grid,
            "--log_dir", str(tmp_path / "logs"), "--checkpoint_dir", str(tmp_path / "ckpt")]
    result = train_segmentation.run(argv)
    assert result.task.model.encoder.conv1.in_channels == 2
    assert result.task.step == 2 and _steps(str(tmp_path / "ckpt")) == [2]
    assert 0.0 <= result.test["test/dice"] <= 1.0
    img = cv2.imread(grid)
    assert img is not None and img.shape == (2 + 66, 2 + 4 * 66, 3)  # one row of 4
    (metrics_csv,) = glob.glob(str(tmp_path / "logs" / "**" / "metrics.csv"), recursive=True)
    with open(metrics_csv) as f:
        rows = list(csv.DictReader(f))
    full = [r for r in rows if r.get("test/full_res_dice")]
    assert full and 0.0 <= float(full[0]["test/full_res_dice"]) <= 1.0


def test_sigterm_checkpoints_and_stops(tmp_path, stores, monkeypatch):
    step = SegmentationTask.train_step

    def step_then_signal(self, *a):
        out = step(self, *a)
        if self.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(SegmentationTask, "train_step", step_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    result = train_segmentation.run(_argv(tmp_path, stores))
    assert result.stopped and result.task.step == 3 and result.test is None
    assert _steps(str(tmp_path / "ckpt")) == [2, 3]
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("flags", [["--resume"], ["--remat"], ["--profile", "3"]])
def test_unported_flags_raise(tmp_path, stores, flags):
    with pytest.raises(SystemExit, match="not ported"):
        train_segmentation.main(_argv(tmp_path, stores, *flags))


def test_cuda_device_raises_without_cuda(monkeypatch, tmp_path, stores):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(tmp_path, stores)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train_segmentation.main(argv[2:])  # cuda is the default


def test_batch_larger_than_the_train_split_raises(tmp_path, stores):
    with pytest.raises(SystemExit, match="exceeds the train split"):
        train_segmentation.main(_argv(tmp_path, stores, "--batch_size", "32"))


@pytest.mark.parametrize("name", ["DECATHLON_HEART", "DECATHLON_LIVER", "DECATHLON_HIPPOCAMPUS", "DECATHLON_LUNG"])
def test_decathlon_datamodules_match_jax(name, stores):
    j, t = jdm.get_datamodule(name)(store_prefix=stores), tdm.get_datamodule(name)(store_prefix=stores)
    for f in ("images_dir", "masks_dir", "split_file", "image_size", "mean", "std", "store_prefix"):
        assert getattr(t, f) == getattr(j, f), f
    jl, tl = j.loader("val", 3), t.loader("val", 3)
    try:
        assert type(tl) is type(jl) and len(tl) == len(jl) == 3
        for (ji, jm), (ti, tm) in zip(jl, tl):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
    finally:
        jl.close()
        tl.close()


def test_device_arrays_keep_dtypes_on_cpu():
    batches = [(np.zeros((2, 4, 4, 1), np.uint8), np.ones((2, 4, 4, 1), np.float32))] * 3
    out = list(device_arrays(batches, "cpu"))
    assert len(out) == 3
    for imgs, msks in out:
        assert imgs.dtype == torch.uint8 and msks.dtype == torch.float32 and tuple(msks.shape) == (2, 4, 4, 1)
