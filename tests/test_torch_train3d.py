"""The port's three volumetric entry points on the CPU: ``mis-train-ssl3d-torch``,
``mis-train-segmentation3d-torch`` and ``mis-predict3d-torch``.

Every run is ``--device cpu --fp32`` at ``--features 4 8`` on a synthetic
Decathlon directory written from a seed with the port's own ``write_nifti``
(10 ragged int16 volumes of about 18×18×11 with sphere masks, a 6/2/2 split
file), fitted to 12×20×20 and cropped to 8×16×16, so the crop origin is drawn
on every axis.

Tolerances. What must be the same computation is held to equality, bit for
bit: ``--device_cache`` and ``--cache_volumes`` against the plain route
(every step's loss, the final checkpoint, the metrics), and a run stopped
by SIGTERM and continued with ``--resume`` against one that was never
stopped (weights, momentum, step, epoch, augmentation generator, the
learning rate of every step). ``mis-predict3d-torch`` is held against the
JAX ``mis-predict3d`` on the same weights (an orbax checkpoint and its
converted ``.pt``): at least 99.9% of the voxels of every mask agree (a
logit within f32 rounding of the threshold may fall either way).
"""

import argparse
import csv
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.core.checkpoint import save_checkpoint as jax_save
from medical_image_segmentation_tpu.train import predict3d as jpredict3d
from medical_image_segmentation_tpu.train import train_segmentation3d as jseg3d
from medical_image_segmentation_tpu.train import train_ssl3d as jssl3d
from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask as JaxSeg3DTask
from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from medical_image_segmentation_tpu_torch.core.convert import unet3d_flax_to_state_dict
from medical_image_segmentation_tpu_torch.data.nifti import read_nifti, write_nifti
from medical_image_segmentation_tpu_torch.train import predict3d, train_segmentation3d, train_ssl3d
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

torch.set_num_threads(2)

N_TRAIN, N_VAL, N_TEST = 6, 2, 2
SIZES = ["--volume_size", "12", "20", "20", "--crop_size", "8", "16", "16", "--features", "4", "8"]


@pytest.fixture(scope="module")
def decathlon(tmp_path_factory):
    """imagesTr / labelsTr in (X, Y, Z) with ±2 of ragged extent around
    18×18×11, so ``center_fit`` both pads and crops, and the split file."""
    root = tmp_path_factory.mktemp("task")
    rng = np.random.default_rng(0)
    (root / "imagesTr").mkdir()
    (root / "labelsTr").mkdir()
    names = [f"case_{i:02d}" for i in range(N_TRAIN + N_VAL + N_TEST)]
    for name in names:
        x, y, z = 18 + rng.integers(-2, 3), 18 + rng.integers(-2, 3), 11 + rng.integers(-2, 3)
        xx, yy, zz = np.mgrid[:x, :y, :z]
        c = [rng.integers(n // 3, 2 * n // 3 + 1) for n in (x, y, z)]
        r = rng.integers(3, 6)
        mask = (xx - c[0]) ** 2 + (yy - c[1]) ** 2 + (zz - c[2]) ** 2 <= r * r
        img = rng.normal(-200, 60, (x, y, z)) + 500 * mask
        write_nifti(str(root / "imagesTr" / f"{name}.nii.gz"), img.astype(np.int16))
        write_nifti(str(root / "labelsTr" / f"{name}.nii.gz"), mask.astype(np.uint8))
    split = {"train": names[:N_TRAIN], "val": names[N_TRAIN:N_TRAIN + N_VAL], "test": names[N_TRAIN + N_VAL:]}
    (root / "split.json").write_text(json.dumps(split))
    return root


def _seg_argv(root, d, *extra):
    # 6 train volumes in batches of 2: 3 steps an epoch, 2 epochs
    return ["--device", "cpu", "--fp32", "--images_dir", str(root / "imagesTr"), "--masks_dir", str(root / "labelsTr"),
            "--split_file", str(root / "split.json"), *SIZES, "--batch_size", "2", "--max_epochs", "2",
            "--warmup_epochs", "0", "--learning_rate", "0.3", "--log_dir", str(d / "logs"),
            "--checkpoint_dir", str(d / "ckpt"), *extra]


def _ssl_argv(root, d, *extra):
    # 10 volumes in batches of 2, capped at 3 steps an epoch: a resumed
    # epoch skips a prefix and leaves batches unread
    return ["--device", "cpu", "--fp32", "--images_dir", str(root / "imagesTr"), *SIZES, "--batch_size", "2",
            "--max_epochs", "2", "--limit_steps_per_epoch", "3", "--warmup_epochs", "0", "--learning_rate", "0.1",
            "--hidden_dim", "32", "--projection_dim", "16", "--log_dir", str(d / "logs"),
            "--checkpoint_dir", str(d / "ckpt"), *extra]


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


def _losses(run):
    return [float(x) for x in run.losses]


def _csv_columns(log_dir):
    with open(os.path.join(log_dir, "lightning_logs", "version_0", "metrics.csv")) as f:
        return set(next(csv.reader(f)))


@pytest.fixture(scope="module")
def seg_reference(decathlon, tmp_path_factory):
    """One uninterrupted plain-route run and its final checkpoint."""
    d = tmp_path_factory.mktemp("seg_ref")
    run = train_segmentation3d.run(_seg_argv(decathlon, d, "--full_res_window", "8", "16", "16"))
    return run, load_checkpoint(run.checkpoint), d


@pytest.fixture(scope="module")
def ssl_reference(decathlon, tmp_path_factory):
    d = tmp_path_factory.mktemp("ssl_ref")
    run = train_ssl3d.run(_ssl_argv(decathlon, d))
    return run, load_checkpoint(run.checkpoint), d


# ------------------------------------------------------------------ the flags


def _options(parse_args, argv):
    """Every option string of the parser behind ``parse_args`` with its default."""
    seen = {}
    original = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        for action in self._actions:
            for opt in action.option_strings:
                seen[opt] = action.default
        return original(self, args, namespace)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        parse_args(argv)
    return seen


# the port's own flags beyond the JAX twin's: nnU-Net's network and recipe (``--arch nnunet3d``)
NNUNET_FLAGS = {"--arch": "unet3d", "--classes": 1}


@pytest.mark.parametrize("jax_mod,port_mod,argv,own", [
    (jseg3d, train_segmentation3d, ["--images_dir", "a", "--masks_dir", "b"], NNUNET_FLAGS),
    (jssl3d, train_ssl3d, ["--images_dir", "a"], {}),
    (jpredict3d, predict3d, ["--images_dir", "a", "--output_dir", "o"], {}),
], ids=["seg3d", "ssl3d", "predict3d"])
def test_every_flag_of_the_jax_twin_plus_device(jax_mod, port_mod, argv, own):
    want, got = _options(jax_mod.parse_args, argv), _options(port_mod.parse_args, argv)
    assert set(got) - set(want) == {"--device", *own} and not set(want) - set(got)
    assert all(got[k] == v for k, v in own.items())  # defaults that leave the JAX twin's run as it was
    assert all(got[k] == want[k] for k in want), {k: (want[k], got[k]) for k in want if got[k] != want[k]}
    assert got["--device"] == "cuda"


@pytest.mark.parametrize("run,argv", [
    (train_segmentation3d.run, ["--images_dir", "a", "--masks_dir", "b"]),
    (train_ssl3d.run, ["--images_dir", "a"]),
    (predict3d.run, ["--images_dir", "a", "--output_dir", "o", "--checkpoint", "c"]),
], ids=["seg3d", "ssl3d", "predict3d"])
def test_the_card_is_the_default_and_raises_without_one(run, argv):
    with pytest.raises(SystemExit, match="CUDA is not available"):
        run(argv)


def test_what_is_not_ported_raises_and_names_its_roadmap_item(decathlon, tmp_path):
    # --space_shards is ported: in one process it is refused with the JAX trainer's text
    with pytest.raises(SystemExit, match=r"--space_shards 2 must divide the device count 1"):
        train_segmentation3d.run(_seg_argv(decathlon, tmp_path, "--space_shards", "2"))
    base = ["--images_dir", str(decathlon / "imagesTr"), "--output_dir", str(tmp_path / "o"), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="m.misx"):  # --exported is served now: a missing artifact is named
        predict3d.run(["--exported", str(tmp_path / "m.misx"), *base])
    with pytest.raises(SystemExit, match="exactly one of"):
        predict3d.run(base)
    with pytest.raises(SystemExit, match="exactly one of"):
        predict3d.run(["--exported", "m.misx", "--checkpoint", "c", *base])
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("run,argv,match", [
    (train_segmentation3d.run, _seg_argv, "exceeds the train split \\(6 volumes\\)"),
    (train_ssl3d.run, _ssl_argv, "exceeds the unlabeled set \\(10 volumes\\)"),
], ids=["seg3d", "ssl3d"])
def test_a_batch_larger_than_the_set_is_refused(decathlon, tmp_path, run, argv, match):
    """Every epoch would run no step (drop_last), so nothing would train."""
    with pytest.raises(SystemExit, match=match + ".*0 steps"):
        run(argv(decathlon, tmp_path, "--batch_size", "16"))
    assert not os.path.exists(tmp_path / "ckpt")


# ---------------------------------------------------------------- the seg3d run


def test_seg3d_run_trains_validates_tests_and_scores_at_full_resolution(seg_reference):
    run, ckpt, d = seg_reference
    assert run.task.step == 6 and not run.stopped and run.resumed_from is None
    losses = _losses(run)
    assert len(losses) == 6 and all(np.isfinite(losses)) and all(0.0 < x < 1.0 for x in losses)
    assert [s for s, _ in run.schedule] == list(range(6))
    assert run.schedule[0][1] == run.schedule[2][1] != run.schedule[3][1]  # the lr holds for an epoch
    assert [e["steps"] for e in run.epochs] == [3, 3]
    assert set(run.val) == {"val/loss", "val/dice", "val/iou"}
    assert set(run.test) == {"test/loss", "test/dice", "test/iou"}
    assert set(run.full_res) == {"test/full_res_dice", "test/full_res_iou"}
    for metrics in (run.val, run.test, run.full_res):
        assert all(0.0 <= v <= 1.0 for v in metrics.values()), metrics
    assert run.hbm is None and run.corpus_bytes == 0  # the CPU has no capacity to guard
    # checkpoints: the end of epoch 0, and the final one with the resume keys
    assert sorted(os.listdir(d / "ckpt")) == ["3.pt", "6.pt"] and run.checkpoint.endswith("6.pt")
    assert ckpt["step"] == 6 and ckpt["epoch"] == 2 and "aug_generator" in ckpt
    assert not any("running_" in k for k in ckpt["model"])  # GroupNorm keeps no statistics
    final = run.task.model.state_dict()
    assert all(not torch.equal(final[k], v) for k, v in run.start_state.items())  # every parameter moved
    assert {"train/loss", "lr", "val/dice", "test/dice", "test/full_res_dice"} <= _csv_columns(d / "logs")


@pytest.mark.parametrize("flag", ["--device_cache", "--cache_volumes"])
def test_cached_routes_equal_the_plain_route_bit_for_bit(decathlon, seg_reference, tmp_path, flag):
    ref, ref_ckpt, _ = seg_reference
    run = train_segmentation3d.run(_seg_argv(decathlon, tmp_path, flag))
    assert _losses(run) == _losses(ref) and run.schedule == ref.schedule
    assert run.val == ref.val and run.test == ref.test
    _assert_equal_trees(load_checkpoint(run.checkpoint), ref_ckpt)
    if flag == "--device_cache":  # f32 volumes and uint8 masks of all three splits
        assert run.corpus_bytes == (N_TRAIN + N_VAL + N_TEST) * 12 * 20 * 20 * 5
    else:
        assert run.corpus_bytes == 0


def test_full_res_window_falls_back_to_the_train_set_without_a_test_split(decathlon, tmp_path):
    split = json.loads((decathlon / "split.json").read_text())
    (tmp_path / "split.json").write_text(json.dumps({"train": split["train"], "val": split["val"], "test": []}))
    argv = _seg_argv(decathlon, tmp_path, "--max_epochs", "1", "--full_res_window", "8", "16", "16")
    argv[argv.index("--split_file") + 1] = str(tmp_path / "split.json")
    run = train_segmentation3d.run(argv)
    assert run.test is None and run.val is not None
    assert set(run.full_res) == {"test/full_res_dice", "test/full_res_iou"}


def test_eval_every_epochs_zero_runs_no_val_at_all(decathlon, tmp_path, monkeypatch):
    """Not even the val set is opened (nor, with --device_cache, pinned)."""
    opened = []
    original = train_segmentation3d.DecathlonVolumeDataset

    def spy(*a, **kw):
        opened.append(kw["split"])
        return original(*a, **kw)

    monkeypatch.setattr(train_segmentation3d, "DecathlonVolumeDataset", spy)
    run = train_segmentation3d.run(_seg_argv(decathlon, tmp_path, "--eval_every_epochs", "0", "--device_cache"))
    assert run.val is None and run.test is not None and opened == ["train", "test"]
    assert run.corpus_bytes == (N_TRAIN + N_TEST) * 12 * 20 * 20 * 5
    assert not any(c.startswith("val/") for c in _csv_columns(tmp_path / "logs"))


def test_eval_every_two_epochs_still_validates_on_the_last(decathlon, tmp_path, capfd):
    run = train_segmentation3d.run(_seg_argv(decathlon, tmp_path, "--max_epochs", "3", "--eval_every_epochs", "2",
                                             "--checkpoint_every_epochs", "0"))
    err = capfd.readouterr().err
    assert "epoch 0: val/" not in err and "epoch 1: val/" in err and "epoch 2: val/" in err
    assert run.val is not None and os.listdir(tmp_path / "ckpt") == ["9.pt"]


def test_hu_windows_become_input_channels_and_remat_changes_nothing(decathlon, tmp_path):
    base = ("--hu_windows", "0.4:0.5,0.7:0.3", "--loss", "dice_ce", "--norm", "batch", "--max_epochs", "1")
    plain = train_segmentation3d.run(_seg_argv(decathlon, tmp_path / "a", *base))
    assert plain.task.model.enc0.conv1.weight.shape[1] == 2
    assert any("running_mean" in k for k in plain.task.model.state_dict())
    remat = train_segmentation3d.run(_seg_argv(decathlon, tmp_path / "b", *base, "--remat"))
    assert _losses(remat) == _losses(plain) and remat.test == plain.test
    _assert_equal_trees(load_checkpoint(remat.checkpoint), load_checkpoint(plain.checkpoint))


# ------------------------------------------------------ ssl3d and the handoff


def test_ssl3d_run_and_its_device_cache_route(decathlon, ssl_reference, tmp_path):
    ref, ref_ckpt, d = ssl_reference
    losses = _losses(ref)
    assert ref.task.step == 6 and len(losses) == 6 and all(np.isfinite(losses)) and all(0.0 <= x <= 4.0 for x in losses)
    assert [s for s, _, _ in ref.schedule] == list(range(6))
    taus = [t for _, _, t in ref.schedule]
    assert taus[0] == pytest.approx(0.99) and taus == sorted(taus)
    assert sorted(os.listdir(d / "ckpt")) == ["3.pt", "6.pt"]
    assert {"online", "target", "optimizer", "step", "epoch", "aug_generator"} <= set(ref_ckpt)
    assert any(k.startswith("encoder.backbone.enc1.") for k in ref_ckpt["online"])
    assert ref_ckpt["online"]["probe.weight"].shape == (2, 8)  # two dummy classes on features[-1]

    cached = train_ssl3d.run(_ssl_argv(decathlon, tmp_path, "--device_cache"))
    assert _losses(cached) == losses and cached.schedule == ref.schedule
    assert cached.corpus_bytes == 10 * 12 * 20 * 20 * 4
    _assert_equal_trees(load_checkpoint(cached.checkpoint), ref_ckpt)


def test_ssl_checkpoint_grafts_the_online_backbone_into_the_encoder(decathlon, ssl_reference, seg_reference, tmp_path):
    _, byol, d = ssl_reference
    run = train_segmentation3d.run(_seg_argv(decathlon, tmp_path, "--ssl_checkpoint", str(d / "ckpt"),
                                             "--max_epochs", "1"))
    fresh = seg_reference[0].start_state  # the same seed without a graft
    backbone = {k[len("encoder.backbone."):]: v for k, v in byol["online"].items()
                if k.startswith("encoder.backbone.")}
    assert set(backbone) == {k for k in run.start_state if k.startswith(("enc", "down"))}
    for k, v in run.start_state.items():
        if k in backbone:
            assert torch.equal(v, backbone[k]), k
        else:  # the decoder and the head keep their own init
            assert k.startswith(("dec", "head")) and torch.equal(v, fresh[k]), k
    assert any(not torch.equal(run.start_state[k], fresh[k]) for k in backbone)
    assert run.task.step == 3 and all(np.isfinite(_losses(run)))
    # a 2-stage backbone does not graft into a 3-stage U-Net's widths
    with pytest.raises(ValueError, match="3D encoder shape mismatches"):
        argv = _seg_argv(decathlon, tmp_path / "x", "--ssl_checkpoint", str(d / "ckpt"))
        argv[argv.index("--features") + 1:argv.index("--features") + 3] = ["8", "16"]
        train_segmentation3d.run(argv)


# ------------------------------------------------------ resume and preemption


def _stop_after(monkeypatch, task_cls, step):
    """Make ``task_cls.train_step`` send this process SIGTERM once the task
    has taken ``step`` steps."""
    original = task_cls.train_step

    def step_then_signal(self, *a, **kw):
        out = original(self, *a, **kw)
        if self.step == step:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(task_cls, "train_step", step_then_signal)
    return original


# mid-epoch 0, the end of epoch 0 (its last step), mid-epoch 1 from the corpus on the device
@pytest.mark.parametrize("stop,extra", [(2, ()), (3, ()), (4, ("--device_cache",))])
def test_seg3d_resume_equals_an_uninterrupted_run(decathlon, seg_reference, tmp_path, monkeypatch, stop, extra):
    ref, ref_ckpt, _ = seg_reference
    original = _stop_after(monkeypatch, Segmentation3DTask, stop)
    before = signal.getsignal(signal.SIGTERM)
    first = train_segmentation3d.run(_seg_argv(decathlon, tmp_path, *extra))
    assert first.stopped and first.task.step == stop and first.test is None
    assert signal.getsignal(signal.SIGTERM) is before
    assert load_checkpoint(first.checkpoint)["epoch"] == stop // 3  # the epoch of the next step's batch

    monkeypatch.setattr(Segmentation3DTask, "train_step", original)
    second = train_segmentation3d.run(_seg_argv(decathlon, tmp_path, "--resume", *extra))
    assert second.resumed_from == stop and second.skipped == stop % 3
    assert second.task.step == 6 and not second.stopped
    assert first.schedule + second.schedule == ref.schedule  # every step ran once, at its own lr
    assert _losses(first) + _losses(second) == _losses(ref)
    _assert_equal_trees(load_checkpoint(second.checkpoint), ref_ckpt)
    assert second.val == ref.val and second.test == ref.test


@pytest.mark.parametrize("stop,extra", [(2, ("--device_cache",)), (4, ())])
def test_ssl3d_resume_equals_an_uninterrupted_run(decathlon, ssl_reference, tmp_path, monkeypatch, stop, extra):
    ref, ref_ckpt, _ = ssl_reference
    original = _stop_after(monkeypatch, BYOLTask, stop)
    first = train_ssl3d.run(_ssl_argv(decathlon, tmp_path, *extra))
    assert first.stopped and first.task.step == stop
    monkeypatch.setattr(BYOLTask, "train_step", original)
    second = train_ssl3d.run(_ssl_argv(decathlon, tmp_path, "--resume", *extra))
    assert second.resumed_from == stop and second.skipped == stop % 3 and second.task.step == 6
    assert first.schedule + second.schedule == ref.schedule
    assert _losses(first) + _losses(second) == _losses(ref)
    _assert_equal_trees(load_checkpoint(second.checkpoint), ref_ckpt)


def test_resume_without_a_checkpoint_starts_fresh_and_refuses_another_epoch_length(decathlon, tmp_path):
    run = train_segmentation3d.run(_seg_argv(decathlon, tmp_path, "--resume", "--max_epochs", "1"))
    assert run.resumed_from is None and run.task.step == 3
    # step 3 opens epoch 1 at 3 steps an epoch; at 1 it would lie past that epoch's end
    with pytest.raises(SystemExit, match="does not fall in its epoch"):
        train_segmentation3d.run(_seg_argv(decathlon, tmp_path, "--resume", "--limit_steps_per_epoch", "1"))


# ------------------------------------------------------------------ predict3d


WINDOWS = "0.4:0.5,0.7:0.3"


@pytest.fixture(scope="module")
def predict_case(tmp_path_factory):
    """A briefly trained JAX ``UNet3D`` per channel count, as an orbax
    checkpoint and as its converted ``.pt``, and three volumes to serve in
    (X, Y, Z): one larger than the window with ragged last windows, one
    smaller than it, and a 4-D one whose channel 0 is served."""
    from medical_image_segmentation_tpu.ops.augment import apply_hu_windows, parse_hu_windows

    d = tmp_path_factory.mktemp("predict3d")
    rng = np.random.default_rng(0)
    msk = np.zeros((2, 8, 16, 16, 1), np.float32)
    msk[:, 2:6, 4:12, 4:12] = 1.0
    vol = msk * 0.8 + rng.random(msk.shape).astype(np.float32) * 0.1
    ckpts = {}
    for in_ch in (1, 2):
        x = jnp.asarray(vol)
        if in_ch == 2:
            x = apply_hu_windows(x, parse_hu_windows(WINDOWS, value_max=1.0))
        task = JaxSeg3DTask(in_channels=in_ch, features=(4, 8), learning_rate=0.3, warmup_epochs=0, max_epochs=100,
                            min_lr=0.0, dtype=jnp.float32)
        state = task.init(jax.random.key(0), (1, 8, 16, 16, in_ch))
        for _ in range(10):
            state, _ = task.train_step(state, x, jnp.asarray(msk))
        host = jax.device_get(state)
        jax_save(str(d / f"jax{in_ch}"), host, 10)
        save_checkpoint(str(d / f"torch{in_ch}"), {"step": 10, "optimizer": {},
                                                   "model": unet3d_flax_to_state_dict(host.params, host.batch_stats)}, 10)
        ckpts[in_ch] = (str(d / f"jax{in_ch}"), str(d / f"torch{in_ch}"))
    vols = d / "vols"
    vols.mkdir()
    big = rng.random((20, 18, 10)).astype(np.float32) * 0.1
    big[6:14, 5:13, 2:7] += 0.8
    write_nifti(str(vols / "big.nii.gz"), big)
    small = rng.random((9, 14, 6)).astype(np.float32) * 0.1
    small[2:7, 3:10, 1:5] += 0.8
    write_nifti(str(vols / "small.nii"), (small * 1000).astype(np.int16))
    write_nifti(str(vols / "four_d.nii.gz"), np.stack([big[:16, :16, :8], big[:16, :16, :8] * 0], axis=-1))
    return ckpts, str(vols)


@pytest.mark.parametrize("in_ch,extra", [(1, []), (2, ["--hu_windows", WINDOWS]), (1, ["--threshold", "0.3"])],
                         ids=["plain", "hu_windows", "threshold"])
def test_predict3d_masks_match_the_jax_cli(predict_case, tmp_path, capfd, in_ch, extra):
    ckpts, vols = predict_case
    common = ["--features", "4", "8", "--images_dir", vols, "--window", "8", "16", "16", "--mean", "0.0", "--std", "1.0",
              "--fp32", *extra]
    out = {}
    for name, main, ckpt, dev in (("jax", jpredict3d.main, ckpts[in_ch][0], []),
                                  ("torch", predict3d.main, ckpts[in_ch][1], ["--device", "cpu"])):
        capfd.readouterr()
        assert main(["--checkpoint", ckpt, "--output_dir", str(tmp_path / name), *common, *dev]) == 0
        out[name] = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    for key in ("metric", "unit", "volumes", "window"):
        assert out["torch"][key] == out["jax"][key], key
    assert out["torch"]["metric"] == "predict3d_megavoxels_per_sec" and out["torch"]["value"] > 0
    assert out["torch"]["windows"] == 8 + 1 + 1  # big: 2·2·2; small and four_d: one window each
    names = ["big_mask.nii.gz", "four_d_mask.nii.gz", "small_mask.nii.gz"]
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "torch")) == names
    shapes = {"big_mask.nii.gz": (20, 18, 10), "small_mask.nii.gz": (9, 14, 6), "four_d_mask.nii.gz": (16, 16, 8)}
    foreground = []
    for n in names:
        t, j = read_nifti(str(tmp_path / "torch" / n)), read_nifti(str(tmp_path / "jax" / n))
        t, j = np.asarray(t.data), np.asarray(j.data)
        assert t.dtype == j.dtype == np.uint8 and t.shape == j.shape == shapes[n]  # the file's (X, Y, Z)
        assert set(np.unique(t)) <= {0, 1}
        assert (t == j).mean() >= 0.999, n
        foreground.append(t.mean())
    assert 0.01 < np.mean(foreground) < 0.99, "the case must have both classes"


def test_predict3d_serves_a_trainer_checkpoint_and_refuses_an_empty_directory(decathlon, seg_reference, tmp_path):
    _, _, d = seg_reference
    summary = predict3d.run(["--checkpoint", str(d / "ckpt" / "6.pt"), "--features", "4", "8", "--device", "cpu",
                             "--images_dir", str(decathlon / "imagesTr"), "--output_dir", str(tmp_path / "m"),
                             "--window", "8", "16", "16", "--batch_windows", "3"])  # bf16 autocast, the default
    assert summary["volumes"] == 10 and len(summary["seconds_per_volume"]) == 10 and summary["seconds"] > 0
    for name in os.listdir(decathlon / "imagesTr"):
        src = read_nifti(str(decathlon / "imagesTr" / name))
        out = read_nifti(str(tmp_path / "m" / (name.split(".nii")[0] + "_mask.nii.gz")))
        assert out.shape == src.shape and np.asarray(out.data).dtype == np.uint8
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no NIfTI volumes"):
        predict3d.run(["--checkpoint", str(d / "ckpt"), "--features", "4", "8", "--device", "cpu",
                       "--images_dir", str(tmp_path / "empty"), "--output_dir", str(tmp_path / "n")])
