"""``mis-train-segmentation3d-torch --space_shards`` as several processes on
the CPU (gloo), on a synthetic Decathlon directory written with the port's
``data/nifti.py``: 8 train, 2 val and 2 test volumes fitted to 16×20×20,
crops of 8×16×16, ``UNet3D`` (4, 8), f32, global batch 4, 2 epochs of 2
steps.

- ``--space_shards 2`` in 2 ranks (a (1, 2) mesh) trains what one process
  trains on the same global batches: the loaders of space peers read the
  same volumes and draws, and each rank takes its depth slab.
- (2 × 2) in 4 ranks trains what 2 data-parallel ranks with
  ``--space_shards 1`` train: the same data shards (the strided shards put
  the rows of a global batch in another order than one process does, and
  the rows' draws with them), each split once more over depth.
- Only rank 0 logs and writes checkpoints; the ranks end equal to the bit;
  val and test metrics are the same on every rank.
- A SIGTERM to rank 1 alone stops both ranks after the same step, and rank
  0's checkpoint of that ``--space_shards 2`` run resumes in one process
  under ``--space_shards 1`` to the end, where it meets the uninterrupted
  one-process run.

Tolerances. Losses and val/test metrics against the reference run: 1e-4
relative (f32 sums over depth slabs in another order, through four steps);
the final parameters per group by max|a-b| over max|b|: 1e-4.
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
from medical_image_segmentation_tpu_torch.data.nifti import write_nifti
from medical_image_segmentation_tpu_torch.train import train_segmentation3d
from test_torch_multiprocess_cli import RUNNER, _assert_bit_equal, _one_writer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


@pytest.fixture(scope="module")
def decathlon(tmp_path_factory):
    root = tmp_path_factory.mktemp("task")
    rng = np.random.default_rng(0)
    (root / "imagesTr").mkdir()
    (root / "labelsTr").mkdir()
    names = [f"case_{i:02d}" for i in range(12)]
    for name in names:
        xx, yy, zz = np.mgrid[:20, :20, :16]
        c = [rng.integers(n // 3, 2 * n // 3 + 1) for n in (20, 20, 16)]
        mask = (xx - c[0]) ** 2 + (yy - c[1]) ** 2 + (zz - c[2]) ** 2 <= rng.integers(3, 7) ** 2
        write_nifti(str(root / "imagesTr" / f"{name}.nii.gz"),
                    (rng.normal(-200, 60, mask.shape) + 500.0 * mask).astype(np.int16))
        write_nifti(str(root / "labelsTr" / f"{name}.nii.gz"), mask.astype(np.uint8))
    (root / "split.json").write_text(json.dumps({"train": names[:8], "val": names[8:10], "test": names[10:]}))
    return root


def _argv(root, d, *extra):
    def argv(rank):
        return ["--device", "cpu", "--fp32", "--images_dir", str(root / "imagesTr"), "--masks_dir",
                str(root / "labelsTr"), "--split_file", str(root / "split.json"), "--volume_size", "16", "20", "20",
                "--crop_size", "8", "16", "16", "--features", "4", "8", "--batch_size", "4", "--max_epochs", "2",
                "--warmup_epochs", "0", "--learning_rate", "0.3", "--log_dir", str(d / f"logs{rank}"),
                "--checkpoint_dir", str(d / "ckpt"), *extra]
    return argv


class Ranks:
    """``world`` trainer processes started at once; ``results()`` waits."""

    def __init__(self, d, argv, world, stop=(-1, 0), env=None):
        d.mkdir(parents=True, exist_ok=True)
        self.d, self.world = d, world
        port = td.free_port()
        self.procs = [subprocess.Popen([sys.executable, "-c", RUNNER, str(d / f"result{r}.pt"), str(stop[0]),
                                        str(stop[1]), "train_segmentation3d", "Segmentation3DTask", *argv(r)],
                                       cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                       env={**os.environ, **td.rank_env(r, world, port), "PYTHONPATH": REPO,
                                            **(env or {})})
                      for r in range(world)]

    def results(self):
        errs = []
        try:
            for p in self.procs:
                errs.append(p.communicate(timeout=300)[1])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, err) in enumerate(zip(self.procs, errs)):
            assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
        return [torch.load(self.d / f"result{r}.pt", weights_only=False) for r in range(self.world)], errs


def _losses(log_dir):
    (path,) = glob.glob(str(log_dir / "**" / "metrics.csv"), recursive=True)
    with open(path) as f:
        return [float(row["train/loss"]) for row in csv.DictReader(f) if row.get("train/loss")]


def _group_err(a, b) -> float:
    worst = {}
    for group in ("norm", "conv"):
        keys = [k for k in b if ("norm" in k) == (group == "norm") and "running_" not in k]
        worst[group] = (max(float((a[k].double() - b[k].double()).abs().max()) for k in keys)
                        / max(float(b[k].abs().max()) for k in keys))
    return max(worst.values())


def _metrics_close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=TOL, abs=1e-6), (k, a[k], b[k])


@pytest.fixture(scope="module")
def runs(decathlon, tmp_path_factory):
    """Every launch at once, and the one-process run meanwhile."""
    d = tmp_path_factory.mktemp("runs")
    launches = {
        "s2": Ranks(d / "s2", _argv(decathlon, d / "s2", "--space_shards", "2"), 2),
        "s2x2": Ranks(d / "s2x2", _argv(decathlon, d / "s2x2", "--space_shards", "2"), 4),
        "dp2": Ranks(d / "dp2", _argv(decathlon, d / "dp2"), 2),
        "stop": Ranks(d / "stop", _argv(decathlon, d / "stop", "--space_shards", "2"), 2, stop=(1, 1),
                      env={"MIS_STOP_SYNC_EVERY": "2"}),
    }
    one = train_segmentation3d.run(_argv(decathlon, d / "one")(0))
    out = {"one": one, "one_dir": d / "one", "dir": d}
    for name, launch in launches.items():
        out[name] = launch.results()
    return out


def test_two_space_ranks_train_what_one_process_trains(runs):
    (r0, r1), errs = runs["s2"]
    d, one = runs["dir"], runs["one"]
    for r, err in enumerate(errs):
        assert f"process {r}/2:" in err and "backend gloo" in err
    _one_writer(d / "s2", lambda r: d / "s2" / f"logs{r}")
    _assert_bit_equal(r0["state"], r1["state"])
    assert r0["step"] == one.task.step == 4
    for got, want in zip(_losses(d / "s2" / "logs0"), _losses(runs["one_dir"] / "logs0"), strict=True):
        assert got == pytest.approx(want, rel=TOL)
    _metrics_close(r0["val"], one.val)
    _metrics_close(r0["test"], one.test)
    assert r0["test"] == r1["test"]
    assert _group_err(r0["state"]["model"], one.task.state_dict()["model"]) <= TOL
    assert sorted(os.listdir(d / "s2" / "ckpt")) == ["2.pt", "4.pt"]


def test_a_2x2_mesh_trains_what_two_data_ranks_train(runs):
    (results, errs), (dp, _) = runs["s2x2"], runs["dp2"]
    d = runs["dir"]
    for r, err in enumerate(errs):
        assert f"process {r}/4:" in err
    for res in results[1:]:
        _assert_bit_equal(results[0]["state"], res["state"])
        assert res["test"] == results[0]["test"]
    assert not any(os.path.exists(d / "s2x2" / f"logs{r}") for r in (1, 2, 3))
    for got, want in zip(_losses(d / "s2x2" / "logs0"), _losses(d / "dp2" / "logs0"), strict=True):
        assert got == pytest.approx(want, rel=TOL)
    _metrics_close(results[0]["val"], dp[0]["val"])
    _metrics_close(results[0]["test"], dp[0]["test"])
    assert _group_err(results[0]["state"]["model"], dp[0]["state"]["model"]) <= TOL


def test_sigterm_is_agreed_and_the_checkpoint_resumes_under_one_space_shard(runs, decathlon):
    (r0, r1), errs = runs["stop"]
    d, one = runs["dir"], runs["one"]
    # rank 1 alone gets the signal after step 1; the ranks agree at every second step
    assert [r0["stopped"], r1["stopped"]] == [True, True] and r0["step"] == r1["step"] == 2
    assert "signal" in errs[1] and "signal" not in errs[0]
    assert sorted(os.listdir(d / "stop" / "ckpt")) == ["2.pt"]
    _assert_bit_equal(r0["state"], r1["state"])
    ckpt = load_checkpoint(str(d / "stop" / "ckpt" / "2.pt"))
    assert {k: v.shape for k, v in ckpt["model"].items()} == {k: v.shape for k, v in
                                                             one.task.state_dict()["model"].items()}
    resumed = train_segmentation3d.run(_argv(decathlon, d / "stop", "--resume", "--space_shards", "1")(0))
    assert resumed.resumed_from == 2 and resumed.task.step == 4 and not resumed.stopped
    for got, want in zip(resumed.losses, one.losses[2:], strict=True):
        assert float(got) == pytest.approx(float(want), rel=TOL)
    _metrics_close(resumed.test, one.test)
    assert _group_err(resumed.task.state_dict()["model"], one.task.state_dict()["model"]) <= TOL
