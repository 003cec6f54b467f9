"""Resume and preemption of the port's two trainers, on the CPU.

A run stopped by SIGTERM (delivered in-process after a chosen step) and
continued with ``--resume`` must equal a run that was never stopped, bit
for bit: weights, BatchNorm buffers, the target encoder, the optimizer's
momentum, the step, the loader's epoch and the augmentation generator's
state, all read from the two runs' final checkpoints, and the learning
rate (and BYOL's τ) of every step. ``--run_single_validation`` on a
checkpoint equals the trainer's own last val pass.
"""

import glob
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter
from medical_image_segmentation_tpu_torch.train import train_segmentation, train_ssl
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Each run writes full-size ResNet-18 checkpoints (~0.1 GB each): drop
    them once the test is done."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _assert_equal_trees(a, b, path=""):
    """Bit-equal nested checkpoints: same keys, equal tensors and values."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def _stop_after(monkeypatch, task_cls, step):
    """Make ``task_cls.train_step`` send this process SIGTERM once the
    task has taken ``step`` steps."""
    original = task_cls.train_step

    def step_then_signal(self, *a, **kw):
        out = original(self, *a, **kw)
        if self.step == step:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(task_cls, "train_step", step_then_signal)
    return original


# ----------------------------------------------------------------- BYOL


@pytest.fixture(scope="module")
def ssl_stores(tmp_path_factory):
    """RADIOLOGY_1M-shaped raw stores: 20 train (5 batches of 4) and 8 val
    64² grayscale images."""
    d = tmp_path_factory.mktemp("rad")
    rng = np.random.default_rng(0)
    for split, n in (("train", 20), ("val", 8)):
        with StoreWriter(str(d / f"{split}.mis"), channels=1, with_labels=True) as w:
            for i in range(n):
                w.add(rng.integers(0, 256, size=(64, 64, 1), dtype=np.uint8), label=i % 10, codec=CODEC_RAW)
    return d


@pytest.fixture
def ssl_env(ssl_stores, monkeypatch):
    monkeypatch.setenv("RADIOLOGY_1M_TRAIN_STORE", str(ssl_stores / "train.mis"))
    monkeypatch.setenv("RADIOLOGY_1M_VAL_STORE", str(ssl_stores / "val.mis"))


def _ssl_argv(d, *extra):
    # 3 steps of the 5 batches an epoch, 2 epochs: a resumed epoch skips a
    # prefix and leaves batches unread
    return ["--device", "cpu", "--dataset", "RADIOLOGY_1M", "--batch_size", "4", "--hidden_dim", "32",
            "--projection_dim", "16", "--max_epochs", "2", "--limit_steps_per_epoch", "3", "--warmup_epochs", "0",
            "--num_workers", "2", "--fp32", "--val_every_epochs", "0", "--log_dir", str(d / "logs"),
            "--checkpoint_dir", str(d / "ckpt"), *extra]


@pytest.fixture(scope="module")
def ssl_reference(ssl_stores, tmp_path_factory):
    """Uninterrupted runs, one per route, and their final checkpoints."""
    out = {}
    for precrop in (False, True):
        d = tmp_path_factory.mktemp("ssl_ref")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RADIOLOGY_1M_TRAIN_STORE", str(ssl_stores / "train.mis"))
            run = train_ssl.run(_ssl_argv(d, *(["--host_precrop"] if precrop else [])))
        out[precrop] = (run, load_checkpoint(str(d / "ckpt")))
        shutil.rmtree(d)
    return out


# (stop after step, host pre-crop): mid-epoch 0, the end of epoch 0 (its
# last step), mid-epoch 1 on the pre-crop route
@pytest.mark.parametrize("stop,precrop", [(2, False), (3, False), (4, True)])
def test_byol_resume_equals_an_uninterrupted_run(ssl_env, ssl_reference, tmp_path, monkeypatch, stop, precrop):
    extra = ["--host_precrop"] if precrop else []
    ref_run, ref_ckpt = ssl_reference[precrop]
    original = _stop_after(monkeypatch, BYOLTask, stop)
    before = signal.getsignal(signal.SIGTERM)
    first = train_ssl.run(_ssl_argv(tmp_path, *extra))
    assert first.stopped and first.task.step == stop
    assert signal.getsignal(signal.SIGTERM) is before
    saved = load_checkpoint(str(tmp_path / "ckpt" / f"{stop}.pt"))
    assert saved["epoch"] == stop // 3  # the epoch of the next step's batch

    monkeypatch.setattr(BYOLTask, "train_step", original)
    second = train_ssl.run(_ssl_argv(tmp_path, "--resume", *extra))
    assert second.resumed_from == stop and second.skipped == stop % 3
    assert second.task.step == 6 and not second.stopped
    # every step ran once, at the schedule's own lr and tau
    assert first.schedule + second.schedule == ref_run.schedule
    assert [s for s, _, _ in ref_run.schedule] == list(range(6))
    _assert_equal_trees(load_checkpoint(str(tmp_path / "ckpt")), ref_ckpt)


def test_byol_resume_restores_the_saved_state_bit_for_bit(ssl_env, tmp_path, monkeypatch):
    _stop_after(monkeypatch, BYOLTask, 4)
    train_ssl.run(_ssl_argv(tmp_path))
    saved = load_checkpoint(str(tmp_path / "ckpt" / "4.pt"))
    task = train_ssl._make_task(train_ssl.parse_args(_ssl_argv(tmp_path)), get_datamodule("RADIOLOGY_1M")(), torch.float32,
                                torch.device("cpu"), steps_per_epoch=3)
    task.load_state_dict(saved)
    restored = {**task.state_dict(), "epoch": saved["epoch"], "aug_generator": saved["aug_generator"]}
    _assert_equal_trees(restored, saved)


def test_resume_without_a_checkpoint_starts_fresh_and_refuses_a_changed_epoch(ssl_env, tmp_path):
    run = train_ssl.run(_ssl_argv(tmp_path, "--resume", "--max_epochs", "1"))
    assert run.resumed_from is None and run.task.step == 3
    # step 3 opens epoch 1 at 3 steps an epoch; at 4 it would lie in epoch 0
    with pytest.raises(SystemExit, match="does not fall in its epoch"):
        train_ssl.run(_ssl_argv(tmp_path, "--resume", "--limit_steps_per_epoch", "4"))


def test_old_checkpoint_without_resume_keys_still_resumes(ssl_env, tmp_path):
    """A ``.pt`` of a task's bare ``state_dict`` (no epoch, no generator
    state) resumes from its step's epoch."""
    task = train_ssl._make_task(train_ssl.parse_args(_ssl_argv(tmp_path)), get_datamodule("RADIOLOGY_1M")(), torch.float32,
                                torch.device("cpu"), steps_per_epoch=3)
    task.step = 3
    save_checkpoint(str(tmp_path / "ckpt"), task.state_dict(), 3)
    run = train_ssl.run(_ssl_argv(tmp_path, "--resume"))
    assert run.resumed_from == 3 and run.skipped == 0 and run.task.step == 6


def test_run_single_validation_equals_the_trainers_last_val(ssl_env, tmp_path):
    run = train_ssl.run(_ssl_argv(tmp_path, "--val_every_epochs", "1"))
    assert run.val and set(run.val) == {"val/loss", "val/acc@1", "val/acc@5"}
    for where in (["--checkpoint_path", str(tmp_path / "ckpt" / "6.pt")], []):  # a file, or the latest in the dir
        single = train_ssl.run(_ssl_argv(tmp_path, "--run_single_validation", *where))
        assert single.val == run.val and single.task.step == 6


# --------------------------------------------------------- segmentation


def _slices(rng, n, size):
    yy, xx = np.mgrid[:size, :size]
    for _ in range(n):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        r = rng.integers(size // 8, size // 4)
        m = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8)
        yield np.clip(rng.normal(80, 20, (size, size)) + 100 * m, 0, 255).astype(np.uint8), m


@pytest.fixture(scope="module")
def seg_stores(tmp_path_factory):
    """Paired raw 64² stores: 12 train (3 batches of 4), 4 val, 4 test."""
    d = tmp_path_factory.mktemp("seg")
    rng = np.random.default_rng(1)
    for split, n in (("train", 12), ("val", 4), ("test", 4)):
        with StoreWriter(str(d / f"s_{split}_images.mis"), channels=1) as wi, \
                StoreWriter(str(d / f"s_{split}_masks.mis"), channels=1) as wm:
            for img, m in _slices(rng, n, 64):
                wi.add(img[..., None], codec=CODEC_RAW)
                wm.add(m[..., None], codec=CODEC_RAW)
    return str(d / "s")


def _seg_argv(d, stores, *extra):
    return ["--device", "cpu", "--images_dir", str(d), "--masks_dir", str(d), "--seg_store_prefix", stores,
            "--batch_size", "4", "--image_size", "64", "--max_epochs", "3", "--limit_steps_per_epoch", "2",
            "--warmup_epochs", "0", "--num_workers", "2", "--fp32", "--log_dir", str(d / "logs"),
            "--checkpoint_dir", str(d / "ckpt"), *extra]


def test_segmentation_resume_equals_an_uninterrupted_run(seg_stores, tmp_path, monkeypatch):
    ref = train_segmentation.run(_seg_argv(tmp_path / "ref", seg_stores))
    ref_ckpt = load_checkpoint(ref.checkpoint)

    original = _stop_after(monkeypatch, SegmentationTask, 3)
    first = train_segmentation.run(_seg_argv(tmp_path, seg_stores))
    assert first.stopped and first.task.step == 3 and first.test is None
    assert load_checkpoint(first.checkpoint)["epoch"] == 1
    monkeypatch.setattr(SegmentationTask, "train_step", original)
    second = train_segmentation.run(_seg_argv(tmp_path, seg_stores, "--resume"))
    assert second.resumed_from == 3 and second.skipped == 1 and second.task.step == 6
    assert first.schedule + second.schedule == ref.schedule
    _assert_equal_trees(load_checkpoint(second.checkpoint), ref_ckpt)
    assert second.test == ref.test and second.val == ref.val
    steps = sorted(int(os.path.basename(p)[:-3]) for p in glob.glob(str(tmp_path / "ckpt" / "*.pt")))
    assert steps == [2, 3, 4, 6]


def test_paired_loader_epoch_drives_the_order(seg_stores):
    """A resume sets the loader's epoch: on the paired store loader it must
    reach the image loader that orders both stores."""
    dm = get_datamodule("DECATHLON_LIVER")(store_prefix=seg_stores, image_size=64)
    a, b = dm.loader("train", 4, seed=0), dm.loader("train", 4, seed=0)
    try:
        next(iter(a))  # epoch 0
        epoch1 = [m for _, m in a]
        b.epoch = 1
        assert b.epoch == 1
        for x, y in zip(epoch1, (m for _, m in b)):
            np.testing.assert_array_equal(x, y)
    finally:
        a.close()
        b.close()
