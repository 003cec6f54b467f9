"""The port's ``mis-train-ssl-torch`` entry point, datamodules and device
feed, on the CPU with a tiny synthetic raw store."""

import csv
import dataclasses
import glob
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.data import datamodules as jdm
from medical_image_segmentation_tpu_torch.data import datamodules as tdm
from medical_image_segmentation_tpu_torch.data.device_feed import device_batches
from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter
from medical_image_segmentation_tpu_torch.train import train_ssl

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def radiology_store(tmp_path, monkeypatch):
    """16 raw 64² uint8 images behind RADIOLOGY_1M_TRAIN_STORE; no val store."""
    path = str(tmp_path / "train.mis")
    rng = np.random.default_rng(0)
    with StoreWriter(path, channels=1) as w:
        for _ in range(16):
            w.add(rng.integers(0, 256, size=(64, 64, 1), dtype=np.uint8), codec=CODEC_RAW)
    monkeypatch.setenv("RADIOLOGY_1M_TRAIN_STORE", path)
    monkeypatch.setenv("RADIOLOGY_1M_VAL_STORE", str(tmp_path / "absent.mis"))
    return path


def _argv(tmp_path, *extra):
    return ["--device", "cpu", "--dataset", "RADIOLOGY_1M", "--batch_size", "4", "--hidden_dim", "32",
            "--projection_dim", "16", "--max_epochs", "1", "--limit_steps_per_epoch", "2",
            "--warmup_epochs", "0", "--num_workers", "2", "--log_dir", str(tmp_path / "logs"),
            "--checkpoint_dir", str(tmp_path / "ckpt"), *extra]


def test_main_trains_two_steps_on_cpu(radiology_store, tmp_path):
    assert train_ssl.main(_argv(tmp_path)) == 0
    (metrics,) = glob.glob(str(tmp_path / "logs" / "**" / "metrics.csv"), recursive=True)
    with open(metrics) as f:
        rows = list(csv.DictReader(f))
    assert rows and all(math.isfinite(float(r["loss"])) for r in rows)
    assert float(rows[0]["lr"]) > 0.0  # warmup 0: the first step moves the weights
    (ckpt,) = glob.glob(str(tmp_path / "ckpt" / "*.pt"))
    state = torch.load(ckpt, weights_only=True)
    assert state["step"] == 2 and set(state) == {"step", "online", "target", "optimizer", "epoch", "aug_generator"}
    assert state["epoch"] == 1  # the next step reads epoch 1's order


def test_run_reports_its_epochs_and_route(radiology_store, tmp_path):
    result = train_ssl.run(_argv(tmp_path, "--checkpoint_every_epochs", "0", "--max_epochs", "2"))
    assert result.task.step == 4 and not result.used_kernel  # the CPU takes the plain version
    assert [e["steps"] for e in result.epochs] == [2, 2]
    assert all(math.isfinite(e["loss"]) and 0.0 <= e["loss"] <= 4.0 for e in result.epochs)


@pytest.mark.parametrize("flags", [
    ["--resume"], ["--model_parallel", "2"], ["--remat"], ["--host_precrop"],
    ["--knn_every_epochs", "1"], ["--profile", "3"], ["--run_single_validation"],
])
def test_unported_flags_raise(tmp_path, flags):
    """The port refuses none of the flags it once refused (their runs are
    tested in test_torch_train_flags.py, test_torch_resume.py and, for
    ``--model_parallel 2`` in two processes, test_torch_multiprocess_cli.py).
    In one process ``--model_parallel 2`` meets the JAX trainer's own
    check: M must divide the device count."""
    train_ssl.refuse_unported(train_ssl.parse_args(_argv(tmp_path, *flags)))
    if flags[0] == "--model_parallel":
        with pytest.raises(SystemExit, match="--model_parallel 2 must divide the device count 1"):
            train_ssl.main(_argv(tmp_path, *flags))
    assert train_ssl._UNPORTED == ()


def test_cuda_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(tmp_path)
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train_ssl.main(argv)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train_ssl.main(argv[2:])  # cuda is the default


def test_port_modules_import_no_jax():
    """Importing every module of the port (and chip_smoke.py) loads no
    jax, flax or optax that was not loaded before."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import medical_image_segmentation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "bad = {m.split('.')[0] for m in set(sys.modules) - before} & {'jax', 'jaxlib', 'flax', 'optax'}\n"
        "assert not bad, sorted(bad)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("name", ["RADIOLOGY_1M", "RADIOLOGY_1M_U16", "CIFAR10", "CIFAR100", "IMAGENET"])
def test_datamodules_match_jax(name, monkeypatch, tmp_path):
    monkeypatch.setenv(f"{name}_TRAIN_STORE", str(tmp_path / "t.mis"))
    j, t = jdm.get_datamodule(name)(), tdm.get_datamodule(name)()
    for f in ("NUM_CLASSES", "channels", "crop_size", "low_res", "has_train_labels", "train_mean", "train_std",
              "val_mean", "val_std", "train_store", "val_store", "value_max"):
        assert getattr(t, f) == getattr(j, f), f
    for recipe, window in (("ffcv", 0.0), ("torchvision", 0.0), ("ffcv", 0.4)):
        j.aug_recipe = t.aug_recipe = recipe
        j.window_prob = t.window_prob = window
        for jc, tc in zip(j.view_configs(), t.view_configs()):
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_device_batches_on_cpu(radiology_store):
    loader = tdm.get_datamodule("RADIOLOGY_1M")().train_loader(4, num_threads=2, seed=0)
    try:
        batches = list(device_batches(loader, "cpu"))
    finally:
        loader.close()
    assert len(batches) == 4
    for imgs, labels in batches:
        assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == (4, 64, 64, 1)
        assert labels.dtype == torch.int64 and tuple(labels.shape) == (4,)
