"""One process on every local device (``parallel/replicas.py``), on the CPU:
``local_devices``, ``Replicas``, the ``devices=`` of both sliding-window
loops, batched and sliding-window ``mis-predict-torch``,
``mis-predict3d-torch`` and the trainers' ``--full_res_window`` with
``devices=[cpu, cpu]`` against the one-device run, and the 3D loop against
the JAX ``sliding_window_predict_3d(mesh=...)`` over the conftest's 8 CPU
devices.

Tolerances. Two replicas on the CPU run the same f32 operations on row
chunks of the one-device batch: logits agree to atol 1e-6 (a convolution
may sum a smaller batch in another order) and masks and mask files are
equal; ``Replicas`` of a linear map equals the map on each chunk to the
bit. Against the
JAX loop the logits agree to 1e-5 of the largest, as in
``test_torch_sliding_window3d.py`` (the two convolutions sum in another
order).
"""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.eval import sliding_window as jsw
from medical_image_segmentation_tpu.models.unet3d import UNet3D as JaxUNet3D
from medical_image_segmentation_tpu.parallel import make_mesh as jax_make_mesh
from medical_image_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from medical_image_segmentation_tpu_torch.core.convert import unet3d_flax_to_state_dict
from medical_image_segmentation_tpu_torch.data.nifti import write_nifti
from medical_image_segmentation_tpu_torch.eval import sliding_window as tsw
from medical_image_segmentation_tpu_torch.parallel.replicas import Replicas, local_devices
from medical_image_segmentation_tpu_torch.serve import make_predict_fn
from medical_image_segmentation_tpu_torch.train import predict, predict3d, train_segmentation, train_segmentation3d
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask
from medical_image_segmentation_tpu_torch.utils.png import write_png

torch.set_num_threads(2)

CPU2 = [torch.device("cpu"), torch.device("cpu")]
WINDOW3 = (8, 16, 16)


def _close(a, b, atol=1e-6):
    a, b = (t.numpy() if isinstance(t, torch.Tensor) else t for t in (a, b))
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= atol, float(np.abs(a - b).max())


# ------------------------------------------------------ devices and replicas


def test_local_devices(monkeypatch):
    assert local_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert local_devices("cuda") == [torch.device("cuda", i) for i in range(4)]
    assert local_devices() == local_devices("cuda")
    assert local_devices("cuda:2") == [torch.device("cuda", 2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        local_devices("cuda")


def test_replicas_refuse_a_card_that_is_not_there():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Replicas(torch.nn.Linear(2, 2), ["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one device"):
        Replicas(torch.nn.Linear(2, 2), [])


@pytest.mark.parametrize("devices,batch", [(CPU2, 8), (["cpu"] * 3, 7), (["cpu"] * 3, 2), (["cpu"] * 3, 1)])
def test_replicas_split_rows_and_gather_them_in_order(devices, batch):
    """Contiguous row chunks (``torch.tensor_split``: 7 rows over 3 are 3,
    2, 2; 2 rows over 3 leave one device idle), one a copy, gathered in row
    order on the first device: the module on each chunk, to the bit, and on
    the whole batch to 1e-6 (a product of one row may sum in another order)."""
    lin = torch.nn.Linear(5, 3)
    x = torch.randn(batch, 5, generator=torch.Generator().manual_seed(batch))
    seen = []
    reps = Replicas(lin, devices, lambda m, rows: seen.append((m, len(rows))) or m(rows))
    got = reps(x)
    with torch.no_grad():
        assert torch.equal(got, torch.cat([lin(c) for c in torch.tensor_split(x, len(devices)) if len(c)]))
        _close(got, lin(x))
    assert [n for _, n in seen] == [len(c) for c in torch.tensor_split(x, len(devices)) if len(c)]
    assert len({id(m) for m, _ in seen}) == len(seen) and all(m is not lin for m, _ in seen)


def test_replicas_are_eval_mode_copies_and_leave_the_module_alone():
    bn = torch.nn.BatchNorm1d(3)
    with torch.no_grad():
        bn.running_mean.fill_(2.0)
    reps = Replicas(bn, CPU2)
    x = torch.randn(6, 3, generator=torch.Generator().manual_seed(0))
    assert bn.training and all(not m.training for m in reps.modules)
    _close(reps(x), bn.eval()(x).detach(), atol=0)
    assert float(bn.running_mean[0]) == 2.0


# ----------------------------------------------------- sliding-window loops


@pytest.fixture(scope="module")
def task2d():
    task = SegmentationTask(arch="resnet18", dtype=torch.float32, device="cpu")
    task.init(3)
    return task


@pytest.fixture(scope="module")
def models3d():
    """A ``UNet3D`` (4, 8) from the JAX init, on both sides."""
    jm = JaxUNet3D(features=(4, 8), dtype=jnp.float32)
    variables = jax.device_get(jax.jit(lambda key: jm.init(key, jnp.zeros((1, *WINDOW3, 1)), train=True))(
        jax.random.key(0)))
    task = Segmentation3DTask(features=(4, 8), dtype=torch.float32, device="cpu")
    task.model.load_state_dict(unet3d_flax_to_state_dict(variables["params"], {}))
    return jax.jit(lambda w: jm.apply(variables, w, train=False)), task


@pytest.mark.parametrize("batch_windows", [16, 3])
def test_sliding_window_2d_over_two_replicas_equals_one_device(task2d, batch_windows):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((70, 90, 1)).astype(np.float32))
    one = tsw.sliding_window_predict(task2d.logits, x, window=32, batch_windows=batch_windows)
    two = tsw.sliding_window_predict(task2d.replicas(CPU2), x, window=32, batch_windows=batch_windows,
                                     devices=CPU2)
    _close(two, one)


def test_the_window_batch_is_rounded_up_to_the_device_count():
    calls = []

    def fn(w):
        calls.append(w.shape[0])
        return w.mean(dim=-1, keepdim=True)

    x = torch.randn(40, 40, 1)
    tsw.sliding_window_predict(fn, x, window=16, batch_windows=5, devices=["cpu"] * 3)
    assert set(calls) == {6}
    calls.clear()
    tsw.sliding_window_predict_3d(fn, torch.randn(8, 24, 24, 1), window=WINDOW3, batch_windows=3, devices=CPU2)
    assert set(calls) == {4}


@pytest.mark.parametrize("dims", [(13, 27, 22), (5, 16, 12)])
def test_sliding_window_3d_over_two_replicas_equals_one_device_and_the_jax_mesh_loop(models3d, dims):
    jax_fn, task = models3d
    x = np.random.default_rng(2).standard_normal((*dims, 1)).astype(np.float32)
    one = tsw.sliding_window_predict_3d(task.logits, torch.from_numpy(x), WINDOW3, batch_windows=4)
    two = tsw.sliding_window_predict_3d(task.replicas(CPU2), torch.from_numpy(x), WINDOW3, batch_windows=4,
                                        devices=CPU2)
    _close(two, one)
    want = np.asarray(jsw.sliding_window_predict_3d(jax_fn, jnp.asarray(x), WINDOW3, batch_windows=4,
                                                    mesh=jax_make_mesh()))
    assert float(np.abs(two.numpy() - want).max() / np.abs(want).max()) <= 1e-5


def test_batched_masks_over_two_replicas(task2d):
    imgs = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (5, 64, 64, 1), dtype=np.uint8))
    one = make_predict_fn(task2d, 0.3, 0.2)(imgs)
    two = make_predict_fn(task2d, 0.3, 0.2, logits=task2d.replicas(CPU2))(imgs)
    assert one.dtype == torch.uint8 and torch.equal(two, one)
    _close(task2d.replicas(CPU2)((imgs.float() - 70) / 50), task2d.logits((imgs.float() - 70) / 50))


# ------------------------------------------------------------------ the CLIs


def _files(d):
    """{name: bytes} of the files in ``d``, gzip members unpacked (their
    header holds the time they were written)."""
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            data = fh.read()
        out[f] = gzip.decompress(data) if f.endswith(".gz") else data
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory, task2d, models3d):
    """A 2D and a 3D checkpoint, five 70×90 PNG slices and two volumes."""
    d = tmp_path_factory.mktemp("served")
    save_checkpoint(str(d / "seg"), {"step": 1, "model": task2d.model.state_dict()}, 1)
    save_checkpoint(str(d / "seg3d"), {"step": 1, "model": models3d[1].model.state_dict()}, 1)
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:70, :90]
    (d / "slices").mkdir()
    for i in range(5):
        img = np.clip(rng.normal(90, 30, (70, 90)) + 90 * ((yy - 35) ** 2 + (xx - 20 - 10 * i) ** 2 < 300), 0, 255)
        write_png(str(d / "slices" / f"s{i}.png"), img.astype(np.uint8))
    (d / "vols").mkdir()
    for i, shape in enumerate([(20, 18, 11), (16, 16, 8)]):
        write_nifti(str(d / "vols" / f"v{i}.nii.gz"), rng.normal(0, 100, shape).astype(np.int16))
    return d


@pytest.mark.parametrize("mode", [[], ["--sliding_window", "32"]], ids=["batched", "sliding"])
def test_predict_cli_over_two_replicas_writes_the_one_device_masks(served, tmp_path, mode):
    def argv(out):
        return ["--checkpoint", str(served / "seg"), "--images_dir", str(served / "slices"), "--output_dir",
                str(tmp_path / out), "--mean", "0.3", "--std", "0.2", "--image_size", "64", "--batch_size", "4",
                "--device", "cpu", "--fp32", *mode]

    one = predict.run(argv("one"))
    two = predict.run(argv("two"), devices=CPU2)
    assert (one["devices"], two["devices"], two["images"]) == (1, 2, 5)
    assert one.get("fused_shapes") == (1 if mode else None) and "fused_shapes" not in two  # two devices: the loop
    assert _files(tmp_path / "two") == _files(tmp_path / "one")


def test_predict3d_cli_over_two_replicas_writes_the_one_device_masks(served, tmp_path):
    def argv(out):
        return ["--checkpoint", str(served / "seg3d"), "--features", "4", "8", "--images_dir", str(served / "vols"),
                "--output_dir", str(tmp_path / out), "--window", *map(str, WINDOW3), "--batch_windows", "3",
                "--device", "cpu", "--fp32"]

    one = predict3d.run(argv("one"))
    two = predict3d.run(argv("two"), devices=CPU2)
    assert (one["devices"], two["devices"], one["fused_shapes"]) == (1, 2, 2) and "fused_shapes" not in two
    assert _files(tmp_path / "two") == _files(tmp_path / "one")


def test_exported_serving_stays_on_one_device(served, tmp_path):
    """``--exported`` serves on one card, as the JAX artifact route does:
    the devices of a checkpoint run are not its."""
    from medical_image_segmentation_tpu_torch.train import export

    art = str(tmp_path / "m.misx")
    export.main(["--checkpoint", str(served / "seg"), "--mean", "0.3", "--std", "0.2", "--image_size", "64",
                 "--batch_sizes", "4", "--output", art, "--device", "cpu", "--fp32"])
    out = predict.run(["--exported", art, "--images_dir", str(served / "slices"), "--output_dir",
                       str(tmp_path / "o"), "--device", "cpu"], devices=CPU2)
    assert out["devices"] == 1 and out["images"] == 5


# ------------------------------------------------------ the trainers' full-res


def _recorder(monkeypatch, module, name):
    calls = []
    original = getattr(module, name)

    def recorded(fn, x, *a, **kw):
        out = original(fn, x, *a, **kw)
        calls.append((x, kw.get("devices"), out, kw.get("window")))
        return out

    monkeypatch.setattr(module, name, recorded)
    return calls


def test_seg3d_full_res_window_uses_the_devices_given(tmp_path, monkeypatch):
    root = tmp_path / "task"
    (root / "imagesTr").mkdir(parents=True)
    (root / "labelsTr").mkdir()
    rng = np.random.default_rng(0)
    names = [f"case_{i}" for i in range(4)]
    for name in names:
        mask = np.zeros((18, 18, 11), np.uint8)
        mask[5:12, 6:13, 3:8] = 1
        write_nifti(str(root / "imagesTr" / f"{name}.nii.gz"), (rng.normal(-200, 60, mask.shape) + 500.0 * mask)
                    .astype(np.int16))
        write_nifti(str(root / "labelsTr" / f"{name}.nii.gz"), mask)
    (root / "split.json").write_text(json.dumps({"train": names[:2], "val": names[2:3], "test": names[3:]}))
    calls = _recorder(monkeypatch, train_segmentation3d, "sliding_window_predict_3d")
    argv = ["--device", "cpu", "--fp32", "--images_dir", str(root / "imagesTr"), "--masks_dir", str(root / "labelsTr"),
            "--split_file", str(root / "split.json"), "--volume_size", "12", "20", "20", "--crop_size", "8", "16",
            "16", "--features", "4", "8", "--batch_size", "2", "--max_epochs", "1", "--warmup_epochs", "0",
            "--full_res_window", "8", "16", "16", "--log_dir", str(tmp_path / "logs"), "--checkpoint_dir",
            str(tmp_path / "ckpt")]
    result = train_segmentation3d.run(argv, devices=CPU2)
    assert len(calls) == 1 and calls[0][1] == CPU2
    x, _, logits, window = calls[0]
    _close(logits, tsw.sliding_window_predict_3d(result.task.logits, x, window=window))
    assert 0.0 <= result.full_res["test/full_res_dice"] <= 1.0


def test_seg2d_full_res_window_uses_the_devices_given(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:72, :88]
    for sub in ("images", "masks"):
        (tmp_path / sub).mkdir()
    for i in range(6):
        m = ((yy - 30 - 2 * i) ** 2 + (xx - 40) ** 2 < 200).astype(np.uint8)
        write_png(str(tmp_path / "images" / f"liver_{i}_0.png"),
                  np.clip(rng.normal(80, 20, m.shape) + 100 * m, 0, 255).astype(np.uint8))
        write_png(str(tmp_path / "masks" / f"liver_{i}_0.png"), m * 255)
    calls = _recorder(monkeypatch, train_segmentation, "sliding_window_predict")
    argv = ["--device", "cpu", "--images_dir", str(tmp_path / "images"), "--masks_dir", str(tmp_path / "masks"),
            "--batch_size", "2", "--image_size", "64", "--max_epochs", "1", "--limit_steps_per_epoch", "1",
            "--warmup_epochs", "0", "--num_workers", "1", "--fp32", "--full_res_window", "32",
            "--log_dir", str(tmp_path / "logs"), "--checkpoint_dir", str(tmp_path / "ckpt")]
    result = train_segmentation.run(argv, devices=CPU2)
    assert calls and all(c[1] == CPU2 for c in calls)
    for x, _, logits, window in calls[:2]:
        _close(logits, tsw.sliding_window_predict(tsw.make_unet_window_fn(result.task), x, window=window))
