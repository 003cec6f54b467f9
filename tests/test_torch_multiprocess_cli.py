"""The PyTorch port's trainers as two processes on the CPU: the twins of
the JAX package's slow ``tests/test_multihost_cli.py``, kept fast at toy
width.

Each rank is a process started with torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) that
runs the trainer's ``run`` with ``--device cpu`` (gloo), then saves what
the run returned. Every rank gets its own ``--log_dir``; the checkpoint
directory is shared, as on a cluster's file system.

- ``mis-train-ssl-torch`` with ``--knn_every_epochs 1``: a ``process r/2``
  line from each rank; only rank 0 logs and writes checkpoints; the
  ranks' parameters are equal to the bit at the end; the KNN accuracy
  equals a one-process evaluation of the same bank (the two ranks' shards
  in rank order, embedded with the final weights);
- ``--model_parallel 2``: the same, with the heads split over the ranks;
  the checkpoint holds whole heads;
- ``mis-train-segmentation-torch`` and ``mis-train-segmentation3d-torch``:
  bit-equal ranks, one writer, the same global val and test metrics on
  both ranks;
- a SIGTERM to rank 1 only: both ranks stop after the same step (the
  agreement every ``MIS_STOP_SYNC_EVERY`` steps), one checkpoint is
  written, and ``--resume`` continues from it on both ranks to the end.
"""

import csv
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist as td
from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint
from medical_image_segmentation_tpu_torch.data import datamodules as tdm
from medical_image_segmentation_tpu_torch.data.device_feed import device_batches
from medical_image_segmentation_tpu_torch.data.nifti import write_nifti
from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter
from medical_image_segmentation_tpu_torch.eval.knn import KNNEvaluator
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.train_ssl import _val_preprocess

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs the trainer in one rank; rank ``stop_rank`` sends itself SIGTERM after its step ``stop_step``
RUNNER = r"""
import os, signal, sys, torch
torch.set_num_threads(2)
out, stop_rank, stop_step, module, cls = sys.argv[1:6]
import importlib
from medical_image_segmentation_tpu_torch.parallel.mesh import shutdown_distributed
trainer = importlib.import_module("medical_image_segmentation_tpu_torch.train." + module)
if int(os.environ["RANK"]) == int(stop_rank):
    task_cls = getattr(trainer, cls)
    original = task_cls.train_step
    def step_then_signal(self, *a, **kw):
        m = original(self, *a, **kw)
        if self.step == int(stop_step):
            os.kill(os.getpid(), signal.SIGTERM)
        return m
    task_cls.train_step = step_then_signal
try:
    result = trainer.run(sys.argv[6:])
    state = result.task.state_dict()  # collective under --model_parallel
    torch.save({"state": state, "step": result.task.step, "stopped": result.stopped,
                "resumed_from": result.resumed_from, "knn_acc": getattr(result, "knn_acc", None),
                "val": result.val, "test": getattr(result, "test", None)}, out)
finally:
    shutdown_distributed()
"""


def run_ranks(tmp, module, cls, argv, stop=(-1, 0), env=None, world=2):
    """Run ``module``'s trainer in ``world`` processes; ``argv(rank)`` gives
    each rank's flags. Returns each rank's saved result and stderr."""
    port = td.free_port()
    procs = []
    for r in range(world):
        cmd = [sys.executable, "-c", RUNNER, str(tmp / f"result{r}.pt"), str(stop[0]), str(stop[1]), module, cls,
               *argv(r)]
        procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                      env={**os.environ, **td.rank_env(r, world, port), "PYTHONPATH": REPO,
                                           **(env or {})}))
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    return [torch.load(tmp / f"result{r}.pt", weights_only=False) for r in range(world)], errs


def _flat(state, prefix=""):
    """{path: tensor} of a nested state dict."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v
    return out


def _assert_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def _one_writer(tmp, logs_of):
    assert glob.glob(str(logs_of(0) / "**" / "metrics.csv"), recursive=True)
    assert not os.path.exists(logs_of(1))


@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    """CIFAR10-shaped labelled raw stores: 24 train, 16 val, 32² RGB."""
    d = tmp_path_factory.mktemp("c10")
    rng = np.random.default_rng(0)
    for split, n in (("train", 24), ("val", 16)):
        with StoreWriter(str(d / f"{split}.mis"), channels=3, with_labels=True) as w:
            for i in range(n):
                w.add(rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8), label=i % 3, codec=CODEC_RAW)
    return {"CIFAR10_TRAIN_STORE": str(d / "train.mis"), "CIFAR10_VAL_STORE": str(d / "val.mis")}


def _ssl_argv(tmp, *extra):
    def argv(rank):
        return ["--device", "cpu", "--dataset", "CIFAR10", "--batch_size", "4", "--hidden_dim", "32",
                "--projection_dim", "16", "--max_epochs", "1", "--limit_steps_per_epoch", "2", "--warmup_epochs",
                "0", "--num_workers", "1", "--fp32", "--log_dir", str(tmp / f"logs{rank}"), "--checkpoint_dir",
                str(tmp / "ckpt"), *extra]
    return argv


def test_ssl_two_processes_with_the_knn_probe(cifar, tmp_path, monkeypatch):
    results, errs = run_ranks(tmp_path, "train_ssl", "BYOLTask", _ssl_argv(tmp_path, "--knn_every_epochs", "1"),
                              env=cifar)
    for r, err in enumerate(errs):
        assert f"process {r}/2:" in err and "backend gloo" in err
    _one_writer(tmp_path, lambda r: tmp_path / f"logs{r}")
    assert [os.path.basename(p) for p in glob.glob(str(tmp_path / "ckpt" / "*"))] == ["2.pt"]
    _assert_bit_equal(results[0]["state"], results[1]["state"])
    assert results[0]["step"] == results[1]["step"] == 2
    assert results[0]["val"] == results[1]["val"] and results[0]["knn_acc"] == results[1]["knn_acc"]
    with open(glob.glob(str(tmp_path / "logs0" / "**" / "metrics.csv"), recursive=True)[0]) as f:
        logged = [float(row["online_knn_val_acc"]) for row in csv.DictReader(f) if row.get("online_knn_val_acc")]
    assert logged == [results[0]["knn_acc"]]

    # one process, the same bank: each rank's shard of every batch, in rank order
    for k, v in cifar.items():
        monkeypatch.setenv(k, v)
    dm = tdm.get_datamodule("CIFAR10")()
    task = BYOLTask(arch="resnet18", in_channels=3, low_res=True, hidden_dim=32, proj_dim=16, num_classes=10,
                    dtype=torch.float32, device="cpu")
    task.load_state_dict(load_checkpoint(str(tmp_path / "ckpt")))

    def interleaved(make):
        loaders = [make(r) for r in range(2)]
        try:
            for pairs in zip(*(device_batches(ld, "cpu") for ld in loaders)):
                yield torch.cat([p[0] for p in pairs]), torch.cat([p[1] for p in pairs])
        finally:
            for ld in loaders:
                ld.close()

    embed = lambda x: task.embed_step(_val_preprocess(x, dm))  # noqa: E731
    acc = KNNEvaluator(num_classes=10, max_bank_size=262144, bank_chunk_size=65536).evaluate(
        embed, interleaved(lambda r: dm.train_loader(2, num_threads=1, seed=0, shard=(r, 2))),
        interleaved(lambda r: dm.val_loader(2, num_threads=1, shard=(r, 2))))
    assert acc == results[0]["knn_acc"]


def test_ssl_model_parallel_two_processes(cifar, tmp_path):
    results, errs = run_ranks(tmp_path, "train_ssl", "BYOLTask", _ssl_argv(tmp_path, "--model_parallel", "2"),
                              env=cifar)
    _assert_bit_equal(results[0]["state"], results[1]["state"])
    ckpt = load_checkpoint(str(tmp_path / "ckpt"))
    whole = BYOLTask(arch="resnet18", in_channels=3, low_res=True, hidden_dim=32, proj_dim=16, num_classes=10,
                     dtype=torch.float32, device="cpu").state_dict()
    assert {k: v.shape for k, v in ckpt["online"].items()} == {k: v.shape for k, v in whole["online"].items()}
    assert ckpt["online"]["predictor.fc1.weight"].shape == (32, 16)
    _one_writer(tmp_path, lambda r: tmp_path / f"logs{r}")


def test_model_parallel_must_divide_the_ranks_and_the_hidden_width(cifar, tmp_path):
    port = td.free_port()
    procs = [subprocess.Popen([sys.executable, "-c", RUNNER, str(tmp_path / f"r{r}.pt"), "-1", "0", "train_ssl",
                               "BYOLTask", *_ssl_argv(tmp_path, "--model_parallel", "2", "--hidden_dim", "33")(r)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**os.environ, **td.rank_env(r, 2, port), "PYTHONPATH": REPO, **cifar})
             for r in range(2)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode != 0 for p in procs)
    assert all("--hidden_dim 33 must be divisible by --model_parallel 2" in e for e in errs)


def test_ssl_sigterm_to_one_rank_stops_both_at_one_step_and_resumes(cifar, tmp_path):
    argv = _ssl_argv(tmp_path, "--max_epochs", "2", "--limit_steps_per_epoch", "3")
    # rank 1 alone gets the signal after step 1; the ranks agree at every second step
    results, errs = run_ranks(tmp_path, "train_ssl", "BYOLTask", argv, stop=(1, 1), env={
        **cifar, "MIS_STOP_SYNC_EVERY": "2"})
    assert [r["stopped"] for r in results] == [True, True]
    assert [r["step"] for r in results] == [2, 2]
    assert "signal" in errs[1] and "signal" not in errs[0]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2.pt"]
    ckpt = load_checkpoint(str(tmp_path / "ckpt" / "2.pt"))
    assert ckpt["epoch"] == 0 and ckpt["step"] == 2
    _assert_bit_equal(results[0]["state"], results[1]["state"])

    resumed, _ = run_ranks(tmp_path, "train_ssl", "BYOLTask",
                           _ssl_argv(tmp_path, "--max_epochs", "2", "--limit_steps_per_epoch", "3", "--resume"),
                           env=cifar)
    assert [r["resumed_from"] for r in resumed] == [2, 2]
    assert [r["step"] for r in resumed] == [6, 6] and not any(r["stopped"] for r in resumed)
    _assert_bit_equal(resumed[0]["state"], resumed[1]["state"])
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2.pt", "3.pt", "6.pt"]


def _disk_slices(rng, n, size):
    yy, xx = np.mgrid[:size, :size]
    for _ in range(n):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        r = rng.integers(size // 8, size // 4)
        m = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8)
        yield np.clip(rng.normal(80, 20, (size, size)) + 100 * m, 0, 255).astype(np.uint8), m


def test_segmentation_two_processes(tmp_path):
    rng = np.random.default_rng(1)
    for split, n in (("train", 8), ("val", 4), ("test", 4)):
        with StoreWriter(str(tmp_path / f"s_{split}_images.mis"), channels=1) as wi, \
                StoreWriter(str(tmp_path / f"s_{split}_masks.mis"), channels=1) as wm:
            for img, m in _disk_slices(rng, n, 64):
                wi.add(img[..., None], codec=CODEC_RAW)
                wm.add(m[..., None], codec=CODEC_RAW)

    def argv(rank):
        return ["--device", "cpu", "--images_dir", str(tmp_path), "--masks_dir", str(tmp_path),
                "--seg_store_prefix", str(tmp_path / "s"), "--batch_size", "4", "--image_size", "64",
                "--max_epochs", "2", "--warmup_epochs", "0", "--num_workers", "1", "--fp32",
                "--log_dir", str(tmp_path / f"logs{rank}"), "--checkpoint_dir", str(tmp_path / "ckpt")]

    results, _ = run_ranks(tmp_path, "train_segmentation", "SegmentationTask", argv)
    _assert_bit_equal(results[0]["state"], results[1]["state"])
    assert results[0]["step"] == 4  # 8 slices, 4 a rank, 2 a step: 2 steps an epoch
    assert results[0]["val"] == results[1]["val"] and results[0]["test"] == results[1]["test"]
    assert 0.0 <= results[0]["test"]["test/dice"] <= 1.0
    _one_writer(tmp_path, lambda r: tmp_path / f"logs{r}")
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2.pt", "4.pt"]


def test_segmentation3d_two_processes(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "imagesTr").mkdir()
    (tmp_path / "labelsTr").mkdir()
    names = [f"case_{i:02d}" for i in range(8)]
    for name in names:
        xx, yy, zz = np.mgrid[:18, :18, :11]
        c = [rng.integers(n // 3, 2 * n // 3 + 1) for n in (18, 18, 11)]
        mask = (xx - c[0]) ** 2 + (yy - c[1]) ** 2 + (zz - c[2]) ** 2 <= rng.integers(3, 6) ** 2
        write_nifti(str(tmp_path / "imagesTr" / f"{name}.nii.gz"),
                    (rng.normal(-200, 60, mask.shape) + 500 * mask).astype(np.int16))
        write_nifti(str(tmp_path / "labelsTr" / f"{name}.nii.gz"), mask.astype(np.uint8))
    (tmp_path / "split.json").write_text(json.dumps({"train": names[:4], "val": names[4:6], "test": names[6:]}))

    def argv(rank):
        return ["--device", "cpu", "--fp32", "--images_dir", str(tmp_path / "imagesTr"), "--masks_dir",
                str(tmp_path / "labelsTr"), "--split_file", str(tmp_path / "split.json"), "--volume_size", "12", "20",
                "20", "--crop_size", "8", "16", "16", "--features", "4", "8", "--norm", "batch", "--batch_size", "4",
                "--max_epochs", "2", "--warmup_epochs", "0", "--learning_rate", "0.3",
                "--log_dir", str(tmp_path / f"logs{rank}"), "--checkpoint_dir", str(tmp_path / "ckpt")]

    results, _ = run_ranks(tmp_path, "train_segmentation3d", "Segmentation3DTask", argv)
    _assert_bit_equal(results[0]["state"], results[1]["state"])
    assert results[0]["step"] == 2 and results[0]["test"] == results[1]["test"]
    _one_writer(tmp_path, lambda r: tmp_path / f"logs{r}")
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1.pt", "2.pt"]
