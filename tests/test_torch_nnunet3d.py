"""nnU-Net's 3d_fullres network and recipe in the port against the plain
float32 statement of ``tests/plain_nnunet3d.py``, at a small size: crops
of 16³, features (4, 8, 16, 16) (four stages, the last width capped, three
deep-supervision outputs of which two weigh), batch 2, seeded weights.

Tolerances: both sides compute in float32 on the CPU, so they differ by
the order of their sums alone (convolution algorithms, InstanceNorm's
``var_mean`` on the channels-last view against ``F.instance_norm``):
1e-5 relative to each tensor's largest magnitude. A conv bias in front of
an InstanceNorm has a gradient of 0 in exact arithmetic (the norm takes
the mean away), so both sides' gradients there are rounding noise of
~1e-13: those leaves are held to be nought on both sides (under 1e-6 of
the largest gradient, and of the largest step) instead.
"""

import argparse
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import plain_nnunet3d as ref
from medical_image_segmentation_tpu_torch.core import profiling
from medical_image_segmentation_tpu_torch.models.plain_unet3d import PlainConvUNet3D, nnunet_features
from medical_image_segmentation_tpu_torch.models.unet3d import group_norm
from medical_image_segmentation_tpu_torch.ops import dice
from medical_image_segmentation_tpu_torch.ops.augment3d import apply_segmentation_3d, sample_volume_draws
from medical_image_segmentation_tpu_torch.ops.schedules import poly
from medical_image_segmentation_tpu_torch.train import train_segmentation3d
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

FEATURES = (4, 8, 16, 16)
CROP = 16
CLASSES = 3
RTOL = 1e-5


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float = RTOL) -> None:
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= rtol * scale, float((got - want).abs().max()) / scale


def _batch(seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, CROP, CROP, CROP, 1, generator=g)
    # liver-and-tumour-like maps: a ball of class 1 holding a smaller ball of class 2
    ax = torch.arange(CROP, dtype=torch.float32)
    d, h, w = torch.meshgrid(ax, ax, ax, indexing="ij")
    labels = torch.zeros(2, CROP, CROP, CROP, 1)
    for b in range(2):
        c = 5.0 + 6.0 * torch.rand(3, generator=g)
        r2 = (d - c[0]) ** 2 + (h - c[1]) ** 2 + (w - c[2]) ** 2
        labels[b, ..., 0] = torch.where(r2 < 30.0, 1.0, 0.0) + torch.where(r2 < 6.0, 1.0, 0.0)
    return x, labels


def _task(**kw) -> Segmentation3DTask:
    task = Segmentation3DTask(arch="nnunet3d", n_classes=CLASSES, features=FEATURES, loss="dice_ce_ds",
                              learning_rate=0.01, momentum=0.99, weight_decay=3e-5, max_epochs=10, steps_per_epoch=5,
                              dtype=torch.float32, device="cpu", **kw)
    task.init(7)
    return task


def _weights(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def net():
    torch.manual_seed(0)
    model = PlainConvUNet3D(1, CLASSES, FEATURES).to(memory_format=torch.channels_last_3d)
    model.reset_parameters(torch.Generator().manual_seed(11))
    return model


@pytest.mark.parametrize("deep_supervision", [True, False])
def test_forward_output_by_output(net, deep_supervision):
    x, _ = _batch()
    net.train(deep_supervision)
    with torch.no_grad(), ref.exact_f32():
        got = net(x)
        want = ref.forward(x, _weights(net), deep_supervision)
    net.train()
    if not deep_supervision:
        got, want = [got], [want]
    assert [tuple(o.shape) for o in got] == [tuple(o.shape) for o in want]
    assert [o.shape[1] for o in got] == ([16, 8, 4] if deep_supervision else [16])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape[-1] == CLASSES
        _close(g, w)


def test_the_deep_supervised_loss(net):
    x, labels = _batch()
    net.train()
    with torch.no_grad():
        outs = net(x)
    got = dice.deep_supervised_dice_ce(outs, labels, dice.deep_supervision_weights(len(outs)))
    want = ref.ds_loss(outs, labels)
    _close(got, want)
    assert dice.deep_supervision_weights(5) == pytest.approx((8 / 15, 4 / 15, 2 / 15, 1 / 15, 0.0))
    # the full-resolution term alone is another number
    assert abs(float(dice.softmax_dice_ce(outs[0], labels)) - float(got)) > 1e-4


def test_labels_downsample_as_nearest_exact():
    labels = torch.randint(0, CLASSES, (2, 16, 16, 16, 1)).float()
    for s in (2, 4, 8):
        want = F.interpolate(labels.permute(0, 4, 1, 2, 3), size=(16 // s,) * 3, mode="nearest-exact")
        assert torch.equal(dice.downsample_labels(labels, (16 // s,) * 3), want.permute(0, 2, 3, 4, 1))


def test_one_task_step_against_the_reference():
    """Loss, every gradient and every parameter after one step of
    ``Segmentation3DTask(arch="nnunet3d")`` (SGD-Nesterov, clipping, poly)."""
    task = _task()
    x, labels = _batch()
    start = _weights(task.model)
    lr = task.schedule(0)
    with ref.exact_f32():
        out = task.train_step(x.contiguous(memory_format=torch.contiguous_format), labels)
        want_loss, grads = ref.loss_and_grads(start, x, labels)
    _close(out["train/loss"], want_loss)
    assert out["lr"] == lr == 0.01
    assert grads["head0.weight"] is None and task.model.head0.weight.grad is None  # the coarsest weighs 0
    g_max = max(float(g.abs().max()) for g in grads.values() if g is not None)
    for name, p in task.model.named_parameters():
        if _nought(name):
            assert max(float(p.grad.abs().max()), float(grads[name].abs().max())) < 1e-6 * g_max
        elif grads[name] is not None:
            _close(p.grad, grads[name])
    after = ref.sgd_step(start, grads, {}, lr)
    _close_steps(task.model, start, after)
    for name, p in task.model.named_parameters():
        if grads[name] is not None:
            assert not torch.equal(p.detach(), start[name])


def _nought(name: str) -> bool:
    """A conv bias in front of an InstanceNorm: its gradient is 0."""
    return name.startswith(("enc", "dec")) and name.endswith(("conv1.bias", "conv2.bias"))


def _close_steps(model, start: dict, after: dict) -> None:
    """Each parameter's step against the reference's."""
    big = max(float((after[k] - start[k]).abs().max()) for k in after)
    for name, p in model.named_parameters():
        got, want = p.detach() - start[name], after[name] - start[name]
        if _nought(name):
            assert max(float(got.abs().max()), float(want.abs().max())) < 1e-6 * big
        else:  # each side rounds the new parameter to float32 once: one ulp of the leaf on top
            ulp = torch.finfo(torch.float32).eps * float(start[name].abs().max())
            assert float((got - want).abs().max()) <= RTOL * float(want.abs().max()) + ulp, name


def test_clipping_binds_and_matches_the_reference():
    task = _task()
    task.clip_norm = 1e-3  # far below the gradient's norm: the clip decides the step
    x, labels = _batch(5)
    start = _weights(task.model)
    with ref.exact_f32():
        task.train_step(x, labels)
        _, grads = ref.loss_and_grads(start, x, labels)
    after = ref.sgd_step(start, grads, {}, 0.01, clip=1e-3)
    _close_steps(task.model, start, after)
    unclipped = ref.sgd_step(start, grads, {}, 0.01)
    assert float((unclipped["enc0.conv1.weight"] - after["enc0.conv1.weight"]).abs().max()) > 1e-6


def test_instance_norm_is_group_norm_with_a_group_a_channel():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 6, 4, 5, 3, generator=g).contiguous(memory_format=torch.channels_last_3d) * 3 + 1
    w, b = torch.randn(6, generator=g), torch.randn(6, generator=g)
    got = group_norm(x, 6, w, b, 1e-5)
    _close(got, F.instance_norm(x, weight=w, bias=b, eps=1e-5))


def test_parameter_count_at_the_published_widths():
    assert nnunet_features() == (32, 64, 128, 256, 320, 320)
    with torch.device("meta"):
        model = PlainConvUNet3D(1, 3, nnunet_features())
    assert sum(p.numel() for p in model.parameters()) == 31_196_399


def test_poly_schedule():
    s = poly(0.01, 1000)
    assert s(0) == 0.01 and s(1000) == 0.0 and s(2000) == 0.0
    assert s(500) == pytest.approx(0.01 * 0.5 ** 0.9)
    assert all(s(k) > s(k + 1) for k in range(999))


def test_three_class_label_maps_crop_and_flip_value_for_value():
    g = torch.Generator().manual_seed(4)
    vols = torch.rand(3, 12, 14, 10, 1, generator=g)
    labels = torch.randint(0, 3, (3, 12, 14, 10, 1), generator=g).float()
    draws = sample_volume_draws(torch.Generator().manual_seed(9), 3, (12, 14, 10), (8, 8, 8))
    _, got = apply_segmentation_3d(draws, vols, labels, (8, 8, 8), dtype=torch.float32, labels=True)
    lab = labels.numpy()
    for b in range(3):
        o = draws["offsets"][b].tolist()
        want = lab[b, o[0]:o[0] + 8, o[1]:o[1] + 8, o[2]:o[2] + 8]
        for ax in range(3):
            if bool(draws["flips"][b, ax]):
                want = np.flip(want, axis=ax)
        np.testing.assert_array_equal(got[b].numpy(), want)
    assert set(np.unique(got.numpy())) <= {0.0, 1.0, 2.0} and (got == 2).any()
    # without labels=True the map is still cut at 0.5, as before
    _, binary = apply_segmentation_3d(draws, vols, labels, (8, 8, 8), dtype=torch.float32)
    assert torch.equal(binary, (got > 0.5).float())


def test_eval_reports_soft_dice_and_per_class_hard_dice():
    task = _task()
    x, labels = _batch()
    m = task.eval_step(x, labels)
    logits = task.logits(x)
    assert logits.shape == (2, CROP, CROP, CROP, CLASSES)
    pred = logits.argmax(-1)
    for c in (1, 2):
        p, t = (pred == c).float(), (labels[..., 0] == c).float()
        want = (2 * (p * t).sum() + 1) / (p.sum() + t.sum() + 1)
        _close(m[f"dice_class{c}"], want)
    assert float(m["dice"]) == pytest.approx((float(m["dice_class1"]) + float(m["dice_class2"])) / 2)
    probs = torch.softmax(logits, -1)[..., 1:]
    onehot = F.one_hot(labels[..., 0].long(), 3)[..., 1:].float()
    dc = (2 * (probs * onehot).sum((0, 1, 2, 3)) + 1e-5) / (probs.sum((0, 1, 2, 3)) + onehot.sum((0, 1, 2, 3)) + 1e-5)
    _close(m["loss"], 1 - dc.mean())


def test_spans_and_the_instance_norm_counter():
    task = _task()
    x, labels = _batch()
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        task.train_step(x, labels)
    names = {e.name for e in prof.events()}
    for span in ("train.step", "train.forward", "seg.loss", "train.backward", "train.grad_exchange",
                 "train.update", "train.metrics", "norm.instance"):
        assert "mis." + span in names
    # values normalized a forward: two norms a block, batch × width × voxels of its level
    sizes = [CROP // 2 ** i for i in range(len(FEATURES))]
    enc = sum(2 * f * s ** 3 for f, s in zip(FEATURES, sizes))
    dec = sum(2 * f * s ** 3 for f, s in zip(FEATURES[:-1], sizes[:-1]))
    assert profiling.counters()["norm.instance_values"] == 2 * (enc + dec)
    # at the published widths and a 128³ crop: 357,212,160 a crop
    big = [128 // 2 ** i for i in range(6)]
    f = nnunet_features()
    assert sum(2 * a * s ** 3 for a, s in zip(f, big)) + sum(2 * a * s ** 3 for a, s in zip(f[:-1], big[:-1])) \
        == 357_212_160
    profiling.reset_counters()


def test_remat_gives_the_same_step_and_counts_once():
    x, labels = _batch()
    plain, remat = _task(), _task(remat=True)
    profiling.reset_counters()
    plain.train_step(x, labels)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        remat.train_step(x, labels)
    once = profiling.counters()["norm.instance_values"]
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _task().train_step(x, labels)
    assert profiling.counters()["norm.instance_values"] == once
    profiling.reset_counters()
    _close_steps(remat.model, _weights(_task().model), _weights(plain.model))


def test_losses_and_archs_that_do_not_match_are_refused():
    with pytest.raises(ValueError, match="deep-supervised"):
        Segmentation3DTask(loss="dice_ce_ds", device="cpu")
    with pytest.raises(ValueError, match="trains with loss 'dice_ce_ds'"):
        Segmentation3DTask(arch="nnunet3d", n_classes=3, features=FEATURES, device="cpu")
    with pytest.raises(ValueError, match="arch must be"):
        Segmentation3DTask(arch="nnunet2d", device="cpu")
    task = _task()
    assert isinstance(task.optimizer, torch.optim.SGD) and task.optimizer.defaults["nesterov"]
    assert task.clip_norm == 12.0 and task.schedule(25) == pytest.approx(0.01 * 0.5 ** 0.9)


def test_the_cli_builds_the_configuration_and_refuses_depth_sharding():
    base = ["--images_dir", "a", "--masks_dir", "b"]
    args = train_segmentation3d.parse_args(base + ["--arch", "nnunet3d", "--classes", "3"])
    assert (args.features, args.loss) == ((32, 64, 128, 256, 320, 320), "dice_ce_ds")
    assert (args.learning_rate, args.weight_decay, args.classes) == (0.01, 3e-5, 3)
    # a flag given keeps its value; the default architecture keeps every default
    assert train_segmentation3d.parse_args(base + ["--arch", "nnunet3d", "--classes", "3", "--learning_rate",
                                                   "1.0"]).learning_rate == 1.0
    plain = train_segmentation3d.parse_args(base)
    assert (plain.arch, plain.classes, plain.learning_rate, plain.loss) == ("unet3d", 1, 1.0, "dice")
    for extra, word in ((["--space_shards", "2"], "--space_shards"), ([], "--classes")):
        argv = base + ["--arch", "nnunet3d"] + (["--classes", "3"] if extra else []) + extra
        with pytest.raises(SystemExit):
            train_segmentation3d.parse_args(argv)
    with pytest.raises(ValueError, match="depth sharding"):
        Segmentation3DTask(arch="nnunet3d", n_classes=3, features=FEATURES, loss="dice_ce_ds", device="cpu",
                           mesh=argparse.Namespace(size=lambda axis: 2, group=lambda axis: None))


def test_the_cli_refusal_names_the_flag(capsys):
    with pytest.raises(SystemExit):
        train_segmentation3d.parse_args(["--images_dir", "a", "--masks_dir", "b", "--arch", "nnunet3d",
                                         "--classes", "3", "--space_shards", "2"])
    assert "--arch nnunet3d does not support --space_shards" in capsys.readouterr().err


def test_the_cli_trains_nnunet3d_on_decathlon_label_maps(tmp_path):
    """``mis-train-segmentation3d-torch --arch nnunet3d --classes 3`` on a
    tiny synthetic Decathlon tree of 3-class label maps, on the CPU."""
    from medical_image_segmentation_tpu_torch.data.nifti import write_nifti

    img_dir, lab_dir = tmp_path / "imagesTr", tmp_path / "labelsTr"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        vol = (rng.normal(size=(20, 20, 18)) * 100).astype(np.int16)
        lab = np.zeros((20, 20, 18), np.uint8)
        lab[4:14, 5:15, 3:13] = 1
        lab[7:10, 8:11, 6:9] = 2
        write_nifti(str(img_dir / f"liver_{i}.nii.gz"), vol)
        write_nifti(str(lab_dir / f"liver_{i}.nii.gz"), lab)
    run = train_segmentation3d.run([
        "--images_dir", str(img_dir), "--masks_dir", str(lab_dir), "--arch", "nnunet3d", "--classes", "3",
        "--features", *map(str, FEATURES), "--volume_size", "16", "20", "20", "--crop_size", "16", "16", "16",
        "--batch_size", "2", "--max_epochs", "2", "--eval_every_epochs", "0", "--device", "cpu", "--fp32",
        "--skip_hbm_check", "--log_dir", str(tmp_path / "logs"), "--checkpoint_dir", str(tmp_path / "ckpt")])
    assert isinstance(run.task.model, PlainConvUNet3D) and run.task.model.head0.out_channels == 3
    assert len(run.losses) == 4 and all(math.isfinite(float(v)) for v in run.losses)
    assert [lr for _, lr in run.schedule] == pytest.approx([0.01 * (1 - k / 4) ** 0.9 for k in range(4)])
    assert 0.0 <= run.test["test/dice"] <= 1.0
