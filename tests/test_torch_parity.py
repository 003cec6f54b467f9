"""``mis-parity-torch`` (the port's ``eval/parity.py``) on the CPU.

The twin of ``tests/test_parity.py``: the same synthetic data
(``tests/test_parity.py:21-47``), ``--smoke --device cpu``, the same
assertions on the report and the markdown table, and idempotency (a second
call re-runs nothing); it takes seconds here, so unlike the reference's it
is not marked slow. The report's ``dataset_stats`` equal, to 1e-6, the
statistics the JAX package's own ``create_subset`` → ``create_store`` →
``compute_stats`` measure on the same data (the JAX pretrain is not run).
A second test runs the harness with the trainers replaced by stand-ins
that write a checkpoint and a metrics CSV, so the stages and the report
assembly are held on their own; and ``--device cuda`` without a card fails
before any stage runs.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.data.dicom import write_dicom
from medical_image_segmentation_tpu.data.nifti import write_nifti


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    ws = tmp_path_factory.mktemp("parity_data")
    dcm_dir = ws / "med_datasets" / "pancreasct"
    dcm_dir.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i in range(10):
        arr = rng.integers(0, 4096, size=(260, 260)).astype(np.uint16)
        write_dicom(str(dcm_dir / f"img{i}.dcm"), arr)
    import cv2

    val_dir = ws / "nih_test_pngs"
    val_dir.mkdir(parents=True)
    for i in range(4):
        arr = rng.integers(0, 65535, size=(96, 96)).astype(np.uint16)
        cv2.imwrite(str(val_dir / f"val{i}.png"), arr)
    (ws / "Task99" / "imagesTr").mkdir(parents=True)
    (ws / "Task99" / "labelsTr").mkdir(parents=True)
    for v in range(3):
        vol = rng.normal(100, 40, size=(64, 64, 4)).astype(np.float32)
        seg = np.zeros((64, 64, 4), np.uint8)
        seg[20:40, 20:40, :] = 1
        write_nifti(str(ws / "Task99" / "imagesTr" / f"la_{v:03d}.nii.gz"), vol)
        write_nifti(str(ws / "Task99" / "labelsTr" / f"la_{v:03d}.nii.gz"), seg)
    return ws


def _argv(dataset, workdir, *extra):
    return ["--workdir", workdir, "--dicom_dirs", str(dataset / "med_datasets"),
            "--decathlon_images", str(dataset / "Task99" / "imagesTr"),
            "--decathlon_labels", str(dataset / "Task99" / "labelsTr"),
            "--val_png_dir", str(dataset / "nih_test_pngs"), "--num_workers", "1", "--smoke", *extra]


def _jax_stats(dataset, tmp_path, subset_size, image_size):
    """What the JAX harness's scan → curate → store → stats stages measure
    on the same data, through the JAX package's own modules."""
    from medical_image_segmentation_tpu.data.ingest import compute_stats, create_store, create_subset

    ws = tmp_path / "jax"
    ws.mkdir()
    dims, hashes = str(ws / "dims.json"), str(ws / "hashes.json")
    for cmd, out in (("dicom_sizes", dims), ("dicom_hashes", hashes)):
        assert create_subset.main([cmd, str(dataset / "med_datasets"), "--output", out, "--num_processes", "1"]) == 0
    assert create_subset.main(["write_subset", "--dimensions_map", dims, "--hashes_map", hashes,
                               "--output_dir", str(ws / "subset"), "--size", str(subset_size),
                               "--num_processes", "1", "--mapping_output", str(ws / "map.json")]) == 0
    stats = {}
    for name, src in (("train", str(ws / "subset")), ("val", str(dataset / "nih_test_pngs"))):
        store = str(ws / f"{name}.mis")
        assert create_store.main(["--png_dir", src, "--output", store, "--max_resolution", str(image_size),
                                  "--num_workers", "1"]) == 0
        assert compute_stats.main(["--store", store, "--center_crop", str(image_size),
                                   "--output", str(ws / f"{name}.json")]) == 0
        with open(ws / f"{name}.json") as f:
            stats[name] = json.load(f)
    return stats


def _check_report(report, out, jax_stats):
    ds = report["dataset_stats"]
    assert ds["reference_mean"] == 57.9764 and ds["reference_std"] == 60.4759
    assert ds["val_measured"] is True
    assert 0.0 < ds["val_measured_mean"] < 255.0 and 0.0 < ds["measured_mean"] < 255.0
    assert ds["val_reference_mean"] == 126.57 and ds["val_reference_std"] == 63.46
    np.testing.assert_allclose(ds["measured_mean"], jax_stats["train"]["mean"][0], rtol=1e-6)
    np.testing.assert_allclose(ds["measured_std"], jax_stats["train"]["std"][0], rtol=1e-6)
    np.testing.assert_allclose(ds["val_measured_mean"], jax_stats["val"]["mean"][0], rtol=1e-6)
    np.testing.assert_allclose(ds["val_measured_std"], jax_stats["val"]["std"][0], rtol=1e-6)
    assert report["reference"]["ssl_config"]["batch_size"] == 2048
    assert report["reference"]["ssl_config"]["max_epochs"] == 200
    assert os.environ["RADIOLOGY_1M_VAL_STORE"].endswith("nih_chest_xray_test.mis")
    assert {r["init"] for r in report["finetune"]} == {"scratch", "ssl"}
    for r in report["finetune"]:
        assert 0.0 <= r["test/dice"] <= 1.0, r
    assert set(report["stage_seconds"]) >= {"scan", "curate", "store", "stats", "pretrain", "slice", "splits"}
    assert "| Init | Labels | test Dice" in out and "lightning_module.py:212" in out


def test_parity_smoke_end_to_end(dataset, tmp_path, capfd, monkeypatch):
    from medical_image_segmentation_tpu_torch.eval import parity

    monkeypatch.delenv("RADIOLOGY_1M_TRAIN_STORE", raising=False)
    monkeypatch.delenv("RADIOLOGY_1M_VAL_STORE", raising=False)
    workdir = str(tmp_path / "parity")
    argv = _argv(dataset, workdir, "--device", "cpu")
    assert parity.main(argv) == 0
    report = json.load(open(os.path.join(workdir, "parity_report.json")))
    _check_report(report, capfd.readouterr().out, _jax_stats(dataset, tmp_path, 8, 64))
    assert report["ssl"]["checkpoint"].endswith(".pt") and 0.0 <= report["ssl"]["loss"] <= 4.0

    assert parity.main(argv) == 0
    report2 = json.load(open(os.path.join(workdir, "parity_report.json")))
    assert report2["stage_seconds"] == {}
    assert report2["finetune"] == report["finetune"]


def _fake_trainer(kind):
    """A stand-in ``main(argv)``: a checkpoint and a PL-layout metrics CSV,
    as the trainers leave them."""
    def main(argv):
        args = dict(zip(argv[::2], argv[1::2]))
        assert args["--device"] == "cpu"
        os.makedirs(args["--checkpoint_dir"], exist_ok=True)
        torch.save({"step": 2}, os.path.join(args["--checkpoint_dir"], "2.pt"))
        log = os.path.join(args["--log_dir"], "lightning_logs", "version_0")
        os.makedirs(log, exist_ok=True)
        row = {"loss": 1.5} if kind == "ssl" else {"test/dice": 0.25 if "--ssl_checkpoint" in args else 0.2,
                                                          "test/iou": 0.1}
        with open(os.path.join(log, "metrics.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            w.writeheader()
            w.writerow(row)
        return 0
    return main


def test_parity_stages_and_report_without_training(dataset, tmp_path, capfd, monkeypatch):
    from medical_image_segmentation_tpu_torch.eval import parity
    from medical_image_segmentation_tpu_torch.train import train_segmentation, train_ssl

    monkeypatch.delenv("RADIOLOGY_1M_TRAIN_STORE", raising=False)
    monkeypatch.delenv("RADIOLOGY_1M_VAL_STORE", raising=False)
    monkeypatch.setattr(train_ssl, "main", _fake_trainer("ssl"))
    monkeypatch.setattr(train_segmentation, "main", _fake_trainer("seg"))
    workdir = str(tmp_path / "parity")
    argv = _argv(dataset, workdir, "--device", "cpu", "--fractions", "10,100")
    assert parity.main(argv) == 0
    report = json.load(open(os.path.join(workdir, "parity_report.json")))
    out = capfd.readouterr().out
    _check_report(report, out, _jax_stats(dataset, tmp_path, 8, 64))
    assert report["ssl"] == {"checkpoint": os.path.join(workdir, "ckpt_ssl", "2.pt"), "loss": 1.5}
    assert [(r["init"], r["label_fraction"]) for r in report["finetune"]] == [
        ("scratch", 100), ("ssl", 100)]  # --smoke keeps the 100% fraction only
    assert "SSL-init ≥ scratch at label fractions: [100]" in out
    splits = sorted(os.listdir(os.path.join(workdir, "splits")))
    assert splits == ["split_100_percent_train.json", "split_10_percent_train.json", "split_25_percent_train.json",
                      "split_50_percent_train.json", "split_all_in_train.json"]
    assert len(os.listdir(os.path.join(workdir, "slices", "images"))) == 12
    assert parity.main(argv) == 0
    report2 = json.load(open(os.path.join(workdir, "parity_report.json")))
    assert report2["stage_seconds"] == {} and report2["finetune"] == report["finetune"]


def test_parity_without_a_card_fails_before_any_stage(dataset, tmp_path, monkeypatch):
    from medical_image_segmentation_tpu_torch.eval import parity

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        parity.main(_argv(dataset, str(tmp_path / "w")))
    assert not os.path.exists(tmp_path / "w" / ".parity_stages" / "scan.done")
