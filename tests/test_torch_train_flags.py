"""The trainers' remaining flags on the CPU: ``--remat``, ``--profile``, the
memory guard behind ``--skip_hbm_check``/``--force_hbm``, ``--host_precrop``
and ``--knn_every_epochs``.

Remat must not change a step: loss, gradients and BatchNorm running
statistics equal to 1e-6 in f32 (on the CPU they agree to the bit). Its
hazard: the recomputed forward of a checkpointed block would update the
running statistics a second time. The guard's probe step must leave no
trace: a run whose probe ran equals a run without it, bit for bit.
"""

import dataclasses
import glob
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.core import hbm as jhbm
from medical_image_segmentation_tpu_torch.core import hbm
from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint
from medical_image_segmentation_tpu_torch.core.profiling import StepProfiler, trace_if
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


# ----------------------------------------------------------------- remat


def _step_record(task, model, batch):
    """One step: its loss, every gradient and every buffer after it."""
    m = task.train_step(*batch)
    loss = float(m["loss"] if "loss" in m else m["train/loss"])
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return loss, grads, {k: v.clone() for k, v in model.named_buffers()}


def _assert_close(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        scale = max(float(b[k].abs().max()), 1e-12)
        assert float((a[k] - b[k]).abs().max()) <= 1e-6 * scale, (what, k)


def _byol(remat):
    task = BYOLTask(arch="resnet18", in_channels=1, hidden_dim=32, proj_dim=16, num_classes=4,
                    warmup_epochs=0, dtype=torch.float32, device="cpu", remat=remat)
    task.init(0)
    return task


def _seg(remat):
    task = SegmentationTask(arch="resnet18", warmup_epochs=0, dtype=torch.float32, device="cpu", remat=remat)
    task.init(0)
    return task


def test_remat_byol_step_equals_the_plain_step():
    rng = np.random.default_rng(0)
    v1, v2 = (torch.from_numpy(rng.standard_normal((4, 32, 32, 1)).astype(np.float32)) for _ in range(2))
    labels = torch.from_numpy(rng.integers(0, 4, 4))
    plain, remat = _byol(False), _byol(True)
    assert not plain.online.encoder.backbone.remat and remat.target.backbone.remat
    a = _step_record(plain, plain.online, (v1, v2, labels))
    b = _step_record(remat, remat.online, (v1, v2, labels))
    assert abs(a[0] - b[0]) <= 1e-6 * abs(a[0])
    _assert_close(b[1], a[1], "gradients")
    _assert_close(b[2], a[2], "online buffers")
    _assert_close(dict(remat.target.named_buffers()), dict(plain.target.named_buffers()), "target buffers")


def test_remat_unet_step_equals_the_plain_step():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 1)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 64, 64, 1)) > 0.5).astype(np.float32))
    plain, remat = _seg(False), _seg(True)
    a = _step_record(plain, plain.model, (x, y))
    b = _step_record(remat, remat.model, (x, y))
    assert abs(a[0] - b[0]) <= 1e-6 * abs(a[0])
    _assert_close(b[1], a[1], "gradients")
    _assert_close(b[2], a[2], "buffers")


def test_remat_recompute_would_move_batchnorm_twice(monkeypatch):
    """Without the recompute flag the buffers of a checkpointed block take
    the momentum twice: the fault the flag prevents."""
    import contextlib

    from medical_image_segmentation_tpu_torch.models import resnet

    monkeypatch.setattr(resnet, "recomputing", lambda modules: contextlib.nullcontext())
    v = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 32, 32, 1)).astype(np.float32))
    plain, remat = _byol(False), _byol(True)
    plain.train_step(v, v.flip(1))
    remat.train_step(v, v.flip(1))
    bufs = "encoder.backbone.layer1.0.bn1.running_mean"
    assert not torch.allclose(remat.online.state_dict()[bufs], plain.online.state_dict()[bufs])


def test_remat_only_under_gradients(monkeypatch):
    """Eval forwards and the target's no-grad forward skip the checkpoint."""
    from medical_image_segmentation_tpu_torch.models import resnet

    task = _byol(True)
    calls = []
    real = resnet.checkpoint
    monkeypatch.setattr(resnet, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    task.embed_step(torch.zeros(2, 32, 32, 1))
    with torch.no_grad():
        task.target(torch.zeros(2, 32, 32, 1))
    assert not calls
    task.online(torch.zeros(2, 32, 32, 1))
    assert len(calls) == 8  # resnet18: 2 blocks in each of 4 stages


# -------------------------------------------------------------- profiler


def test_step_profiler_writes_on_a_short_run(tmp_path):
    prof = StepProfiler(10, str(tmp_path), "cpu")
    for _ in range(3):  # fewer steps than asked
        torch.randn(64, 64) @ torch.randn(64, 64)
        prof.tick()
    assert prof.path is None  # still tracing
    prof.stop()
    assert prof.path == str(tmp_path / "trace" / "trace.json")
    with open(prof.path) as f:
        assert any("mm" in e.get("name", "") for e in json.load(f)["traceEvents"])
    prof.stop()  # idempotent


def test_step_profiler_stops_after_its_steps_and_trace_if_writes_on_error(tmp_path):
    prof = StepProfiler(2, str(tmp_path / "a"), "cpu")
    prof.tick()
    prof.tick()
    assert os.path.exists(tmp_path / "a" / "trace" / "trace.json")
    assert StepProfiler(0, str(tmp_path / "b"), "cpu").path is None
    with pytest.raises(RuntimeError):
        with trace_if(str(tmp_path / "c"), enabled=True, device="cpu"):
            torch.ones(3).sum()
            raise RuntimeError("a failing block")
    assert os.path.exists(tmp_path / "c" / "trace.json")


def test_profilers_take_no_default_device(tmp_path):
    """A caller that forgot the device would trace the host only and say
    nothing, so both raise instead."""
    with pytest.raises(TypeError):
        StepProfiler(2, str(tmp_path))
    with pytest.raises(TypeError):
        with trace_if(str(tmp_path), enabled=True):
            pass
    assert not os.listdir(tmp_path)


# ------------------------------------------------------------ memory guard


def test_guard_is_a_no_op_without_capacity():
    ran = []
    assert hbm.device_hbm_capacity("cpu") is None
    assert hbm.guard_step(lambda: ran.append(1), device="cpu") is None
    assert hbm.guard_step(lambda: ran.append(1), skip=True, capacity=10) is None
    assert not ran


def test_guard_refuses_with_the_jax_text_and_force_warns(monkeypatch, capsys):
    monkeypatch.setattr(hbm, "probe_peak", lambda probe, device: 2 * 2**30)
    with pytest.raises(SystemExit) as exc:
        hbm.guard_step(lambda: None, label="ssl train step", capacity=2**30, device="cpu")
    with pytest.raises(SystemExit) as jexc:
        jhbm.check_hbm({"projected_peak": 2 * 2**30, "arguments": 0, "outputs": 0, "temp": 0, "aliased": 0,
                        "capacity": 2**30, "oversubscribed": True}, label="ssl train step")
    ours, theirs = str(exc.value), str(jexc.value)
    for phrase in ("REFUSING: ssl train step: projected peak exceeds device", "Lower --batch_size",
                   "--remat", "pass --force_hbm to run anyway."):
        assert phrase in ours and phrase in theirs, phrase
    assert "2.00 GiB (peak of one probe step) vs capacity 1.00 GiB" in capsys.readouterr().err
    mem = hbm.guard_step(lambda: None, label="seg", capacity=2**30, force=True, device="cpu")
    assert mem["oversubscribed"] and "WARNING (forced): seg: projected peak" in capsys.readouterr().err
    monkeypatch.setattr(hbm, "probe_peak", lambda probe, device: None)  # the probe ran out of memory
    with pytest.raises(SystemExit, match="REFUSING"):
        hbm.guard_step(lambda: None, capacity=2**30, device="cpu")
    assert "out of memory" in capsys.readouterr().err
    monkeypatch.setattr(hbm, "probe_peak", lambda probe, device: 2**29)
    assert not hbm.guard_step(lambda: None, capacity=2**30, device="cpu")["oversubscribed"]


def test_preserved_puts_the_task_and_generator_back():
    task = _byol(False)
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((4, 32, 32, 1)).astype(np.float32))
    task.train_step(v, v.flip(2))  # optimizer state exists
    gen = torch.Generator().manual_seed(9)
    before = hbm._cpu_copy(task.state_dict())
    gen_before = gen.get_state()
    with hbm.preserved(task, gen):
        torch.rand(5, generator=gen)
        task.train_step(v.flip(1), v)
    after = task.state_dict()
    assert after["step"] == before["step"] == 1 and torch.equal(gen.get_state(), gen_before)
    for side in ("online", "target"):
        assert all(torch.equal(after[side][k], before[side][k]) for k in before[side])
    for pid, st in before["optimizer"]["state"].items():
        assert torch.equal(after["optimizer"]["state"][pid]["momentum_buffer"], st["momentum_buffer"])
    assert all(p.grad is None for p in task.online.parameters())


# --------------------------------------------------- the trainers' flags


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A CIFAR10-shaped labelled pair of raw stores (24 train, 16 val) and
    a RADIOLOGY_1M-shaped train store (16 images of 48²)."""
    d = tmp_path_factory.mktemp("flags")
    rng = np.random.default_rng(0)
    for split, n in (("train", 24), ("val", 16)):
        with StoreWriter(str(d / f"c10_{split}.mis"), channels=3, with_labels=True) as w:
            for i in range(n):
                w.add(rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8), label=i % 10, codec=CODEC_RAW)
    with StoreWriter(str(d / "rad.mis"), channels=1) as w:
        for _ in range(16):
            w.add(rng.integers(0, 256, size=(48, 48, 1), dtype=np.uint8), codec=CODEC_RAW)
    return d


@pytest.fixture
def env(stores, monkeypatch):
    monkeypatch.setenv("CIFAR10_TRAIN_STORE", str(stores / "c10_train.mis"))
    monkeypatch.setenv("CIFAR10_VAL_STORE", str(stores / "c10_val.mis"))
    monkeypatch.setenv("RADIOLOGY_1M_TRAIN_STORE", str(stores / "rad.mis"))
    monkeypatch.setenv("RADIOLOGY_1M_VAL_STORE", str(stores / "absent.mis"))


def _argv(d, dataset, *extra):
    return ["--device", "cpu", "--dataset", dataset, "--batch_size", "4", "--hidden_dim", "32",
            "--projection_dim", "16", "--max_epochs", "1", "--limit_steps_per_epoch", "3", "--warmup_epochs", "0",
            "--num_workers", "2", "--fp32", "--log_dir", str(d / "logs"), "--checkpoint_dir", str(d / "ckpt"),
            *extra]


def test_host_precrop_routes_the_views_through_the_tail(env, tmp_path, monkeypatch):
    calls = []
    real = train_ssl.two_view_tail_augment

    def spy(gen, views, *a, **kw):
        calls.append(tuple(views.shape))
        return real(gen, views, *a, **kw)

    monkeypatch.setattr(train_ssl, "two_view_tail_augment", spy)
    run = train_ssl.run(_argv(tmp_path, "RADIOLOGY_1M", "--host_precrop"))
    assert run.task.step == 3 and not run.used_kernel
    assert calls == [(8, 112, 112, 1)] * 3  # 2 views of 4 samples, at the crop size


def test_host_precrop_refuses_blur_and_unshared_geometry(env, tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="no GaussianBlur"):
        train_ssl.run(_argv(tmp_path, "RADIOLOGY_1M", "--host_precrop", "--aug_recipe", "torchvision"))
    from medical_image_segmentation_tpu_torch.data import datamodules

    real = datamodules.SSLDataModule.view_configs
    monkeypatch.setattr(datamodules.SSLDataModule, "view_configs",
                        lambda self: (real(self)[0], dataclasses.replace(real(self)[1], hflip_prob=0.0)))
    with pytest.raises(SystemExit, match="share crop geometry"):
        train_ssl.run(_argv(tmp_path, "RADIOLOGY_1M", "--host_precrop"))


def test_knn_probe_in_the_trainer_uses_the_chunked_path(env, tmp_path, monkeypatch, capsys):
    from medical_image_segmentation_tpu_torch.eval import knn

    chunked = []
    real = knn.knn_predict_chunked
    monkeypatch.setattr(knn, "knn_predict_chunked", lambda *a, **kw: chunked.append(1) or real(*a, **kw))
    run = train_ssl.run(_argv(tmp_path, "CIFAR10", "--knn_every_epochs", "1", "--knn_bank_size", "20",
                              "--knn_bank_chunk", "8"))
    assert run.knn_acc is not None and 0.0 <= run.knn_acc <= 1.0
    assert len(chunked) == 4  # one a val batch: the 20-row bank is over the 8-row chunk
    assert f"online_knn_val_acc={run.knn_acc:.4f}" in capsys.readouterr().err


def test_profile_traces_and_reports_the_loader(env, tmp_path, capsys):
    run = train_ssl.run(_argv(tmp_path, "CIFAR10", "--profile", "2", "--max_epochs", "2"))
    assert run.trace == str(tmp_path / "logs" / "trace" / "trace.json") and os.path.exists(run.trace)
    err = capsys.readouterr().err
    assert "loader stages (epoch 0):\ndecode:" in err and "loader stages (epoch 1):" in err


def test_profile_trace_is_written_when_a_signal_stops_the_run(env, tmp_path, monkeypatch):
    original = BYOLTask.train_step

    def step_then_signal(self, *a, **kw):
        out = original(self, *a, **kw)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(BYOLTask, "train_step", step_then_signal)
    run = train_ssl.run(_argv(tmp_path, "CIFAR10", "--profile", "5"))
    assert run.stopped and run.task.step == 1 and os.path.exists(run.trace)


def _force_guard(monkeypatch, peak):
    """A 1 GiB card on the CPU: the probe step runs, its peak is ``peak``."""
    monkeypatch.setattr(hbm, "device_hbm_capacity", lambda device: 2**30)
    monkeypatch.setattr(hbm, "probe_peak", lambda probe, device: (probe(), peak)[1])


def test_guard_probe_is_not_a_hidden_training_step(env, tmp_path, monkeypatch):
    ref = train_ssl.run(_argv(tmp_path / "ref", "CIFAR10", "--skip_hbm_check"))
    _force_guard(monkeypatch, 2**31)
    with pytest.raises(SystemExit, match="REFUSING"):
        train_ssl.run(_argv(tmp_path / "refused", "CIFAR10"))
    run = train_ssl.run(_argv(tmp_path / "forced", "CIFAR10", "--force_hbm"))
    assert run.hbm["oversubscribed"] and ref.hbm is None
    a, b = (load_checkpoint(str(d / "ckpt")) for d in (tmp_path / "ref", tmp_path / "forced"))
    for side in ("online", "target"):
        assert all(torch.equal(a[side][k], b[side][k]) for k in a[side])
    assert torch.equal(a["aug_generator"], b["aug_generator"]) and a["step"] == b["step"] == 3


def test_segmentation_trainer_takes_remat_profile_and_the_guard(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    for split, n in (("train", 8), ("val", 4), ("test", 4)):
        with StoreWriter(str(tmp_path / f"s_{split}_images.mis"), channels=1) as wi, \
                StoreWriter(str(tmp_path / f"s_{split}_masks.mis"), channels=1) as wm:
            for _ in range(n):
                wi.add(rng.integers(0, 256, size=(64, 64, 1), dtype=np.uint8), codec=CODEC_RAW)
                wm.add((rng.random((64, 64, 1)) > 0.5).astype(np.uint8), codec=CODEC_RAW)
    argv = ["--device", "cpu", "--images_dir", str(tmp_path), "--masks_dir", str(tmp_path), "--seg_store_prefix",
            str(tmp_path / "s"), "--batch_size", "4", "--image_size", "64", "--max_epochs", "1", "--warmup_epochs",
            "0", "--num_workers", "2", "--fp32", "--log_dir", str(tmp_path / "logs")]
    plain = train_segmentation.run(argv + ["--checkpoint_dir", str(tmp_path / "a")])
    _force_guard(monkeypatch, 2**29)
    remat = train_segmentation.run(argv + ["--checkpoint_dir", str(tmp_path / "b"), "--remat", "--profile", "1"])
    assert remat.task.model.encoder.remat and remat.hbm == {"projected_peak": 2**29, "capacity": 2**30,
                                                            "oversubscribed": False}
    assert os.path.exists(remat.trace) and remat.task.step == plain.task.step == 2
    a, b = load_checkpoint(plain.checkpoint), load_checkpoint(remat.checkpoint)
    _assert_close(b["model"], a["model"], "seg weights and buffers after remat")
    assert glob.glob(str(tmp_path / "logs" / "**" / "metrics.csv"), recursive=True)
