"""The port's sliding-window inference, ``mis-predict-torch``, serving
function and PNG writer against the JAX package's, on the CPU.

- ``sliding_window_predict`` on odd sizes and on an image smaller than the
  window, with a window function that is the same closed form on both
  sides and depends on the position inside the window, so the Hann blend
  and the padded tail matter: f32, atol 1e-6.
- Both CLI modes in ``--fp32`` against JAX ``mis-predict`` on the same
  weights (an orbax checkpoint and its converted ``.pt``), on the same
  PNG slices: at least 99.9% of mask and overlay pixels agree (a logit
  within f32 rounding of the threshold may fall either way).
- The PNG writer: OpenCV decodes what it writes to the same pixels.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu import serve as jserve
from medical_image_segmentation_tpu.core.checkpoint import save_checkpoint as jax_save
from medical_image_segmentation_tpu.data.dicom import write_dicom
from medical_image_segmentation_tpu.eval import sliding_window as jsw
from medical_image_segmentation_tpu.train import predict as jpredict
from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask as JaxSegTask
from medical_image_segmentation_tpu.utils import viz as jviz
from medical_image_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from medical_image_segmentation_tpu_torch.core.convert import unet_flax_to_state_dict
from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter
from medical_image_segmentation_tpu_torch import serve as tserve
from medical_image_segmentation_tpu_torch.eval import sliding_window as tsw
from medical_image_segmentation_tpu_torch.train import predict as tpredict
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask
from medical_image_segmentation_tpu_torch.utils import viz as tviz
from medical_image_segmentation_tpu_torch.utils.png import decode_png, encode_png, write_png

torch.set_num_threads(2)


def _jax_window_fn(w):
    """(N, S, S, C) → (N, S, S, 2): a closed form that depends on the
    position inside the window."""
    s = w.shape[1]
    ramp = jnp.arange(s, dtype=jnp.float32).reshape(1, s, 1, 1) / s
    a = jnp.tanh(w.mean(axis=-1, keepdims=True))
    return jnp.concatenate([a * ramp, a - ramp], axis=-1)


def _torch_window_fn(w):
    s = w.shape[1]
    ramp = torch.arange(s, dtype=torch.float32).reshape(1, s, 1, 1) / s
    a = torch.tanh(w.mean(dim=-1, keepdim=True))
    return torch.cat([a * ramp, a - ramp], dim=-1)


@pytest.mark.parametrize("hw,window,stride,batch", [((100, 150), 64, 0, 4), ((40, 50), 64, 0, 16),
                                                    ((70, 64), 32, 24, 3)])
def test_sliding_window_predict_matches_jax(hw, window, stride, batch):
    x = np.random.default_rng(0).standard_normal((*hw, 2)).astype(np.float32)
    want = jsw.sliding_window_predict(_jax_window_fn, jnp.asarray(x), window, stride=stride,
                                      batch_windows=batch, num_classes=2)
    got = tsw.sliding_window_predict(_torch_window_fn, torch.from_numpy(x), window, stride=stride,
                                     batch_windows=batch, num_classes=2)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (*hw, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("h,w,window", [(512, 512, 224), (100, 150, 64), (40, 50, 64), (224, 224, 224),
                                        (225, 600, 96)])
def test_count_windows_matches_the_jax_grid(h, w, window):
    """The JAX CLI's own count (``train/predict.py:257-259``) and the grid
    ``sliding_window_predict`` tiles."""
    n = 1
    for full in (h, w):
        n *= len(jsw._window_starts(max(full, window), window, max(1, window // 2)))
    assert tsw.count_windows(h, w, window) == n
    ys = jsw._window_starts(max(h, window), window, window // 2)
    xs = jsw._window_starts(max(w, window), window, window // 2)
    np.testing.assert_array_equal(tsw.window_grid(h, w, window), [(y, x) for y in ys for x in xs])
    np.testing.assert_array_equal(tsw._blend_weights(window), jsw._blend_weights(window))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One random-init U-Net as an orbax checkpoint (JAX) and a .pt (port)."""
    d = tmp_path_factory.mktemp("ckpt")
    task = JaxSegTask(arch="resnet18", dtype=jnp.float32)
    state = task.init(jax.random.key(0), (2, 64, 64, 1))
    jax_save(str(d / "jax"), state, step=1)
    host = jax.device_get(state)
    save_checkpoint(str(d / "torch"), {"step": 1, "model": unet_flax_to_state_dict(host.params, host.batch_stats),
                                       "optimizer": {}}, 1)
    return str(d / "jax"), str(d / "torch")


@pytest.fixture(scope="module")
def slices(tmp_path_factory):
    """Five 70×90 grayscale PNG slices."""
    d = tmp_path_factory.mktemp("slices")
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:70, :90]
    for i in range(5):
        img = np.clip(rng.normal(90, 30, (70, 90)) + 90 * ((yy - 35) ** 2 + (xx - 20 - 10 * i) ** 2 < 300), 0, 255)
        cv2.imwrite(str(d / f"s{i}.png"), img.astype(np.uint8))
    return str(d)


@pytest.mark.parametrize("mode", [[], ["--sliding_window", "64"]])
def test_cli_matches_jax_predict(tmp_path, checkpoints, slices, capfd, mode):
    jax_ckpt, torch_ckpt = checkpoints
    common = ["--dataset", "DECATHLON_HEART", "--image_size", "64", "--images_dir", slices,
              "--batch_size", "4", "--num_workers", "1", "--fp32", *mode]
    out = {}
    for name, main, ckpt, extra in (("jax", jpredict.main, jax_ckpt, []),
                                    ("torch", tpredict.main, torch_ckpt, ["--device", "cpu"])):
        capfd.readouterr()
        assert main(["--checkpoint", ckpt, "--output_dir", str(tmp_path / name / "m"),
                     "--overlay_dir", str(tmp_path / name / "o"), *common, *extra]) == 0
        out[name] = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    for key in ("metric", "unit", "images", "mode", "exported"):
        assert out["torch"][key] == out["jax"][key], key
    assert out["torch"]["images"] == 5
    names = sorted(os.listdir(tmp_path / "jax" / "m"))
    assert names == sorted(os.listdir(tmp_path / "torch" / "m")) == [f"s{i}_mask.png" for i in range(5)]
    agree = []
    for sub, flag in (("m", cv2.IMREAD_UNCHANGED), ("o", cv2.IMREAD_COLOR)):
        for n in names:
            j = cv2.imread(str(tmp_path / "jax" / sub / n), flag)
            t = cv2.imread(str(tmp_path / "torch" / sub / n), flag)
            assert t.shape == j.shape and t.dtype == j.dtype == np.uint8, (sub, n)
            if sub == "m":
                assert j.shape == (70, 90) and set(np.unique(t)) <= {0, 255}
            agree.append((t == j).reshape(len(t), -1).all(axis=1).mean() if sub == "o" else (t == j).mean())
    masks_on = np.mean([cv2.imread(str(tmp_path / "torch" / "m" / n), 0).mean() / 255 for n in names])
    assert 0.01 < masks_on < 0.99, "the case must have both classes"
    assert min(agree) >= 0.999, agree


def test_cli_refuses_what_it_cannot_serve(tmp_path, checkpoints):
    base = ["--output_dir", str(tmp_path / "o"), "--device", "cpu", "--dataset", "DECATHLON_HEART"]
    with pytest.raises(SystemExit, match="exactly one of"):
        tpredict.main(["--checkpoint", checkpoints[1], *base])
    with pytest.raises(SystemExit, match="not ported"):
        tpredict.main(["--exported", "m.misx", "--images_dir", str(tmp_path), *base])
    with pytest.raises(SystemExit, match="--checkpoint is required"):
        tpredict.main(["--images_dir", str(tmp_path), *base])
    with pytest.raises(SystemExit, match="--mean/--std"):
        tpredict.main(["--checkpoint", checkpoints[1], "--images_dir", str(tmp_path), "--output_dir",
                       str(tmp_path / "o"), "--device", "cpu"])


def test_serving_from_a_store_in_both_modes(tmp_path, checkpoints):
    store = str(tmp_path / "s.mis")
    rng = np.random.default_rng(4)
    with StoreWriter(store, channels=1) as w:
        for _ in range(3):
            w.add(rng.integers(0, 256, size=(96, 96, 1), dtype=np.uint8), codec=CODEC_RAW)
    for mode, extra in (("batched", []), ("sliding_window", ["--sliding_window", "64"])):
        summary = tpredict.run(["--checkpoint", checkpoints[1], "--image_store", store, "--device", "cpu",
                                "--mean", "0.2", "--std", "0.2", "--image_size", "64", "--batch_size", "2",
                                "--num_workers", "1", "--output_dir", str(tmp_path / mode), *extra])
        assert summary["images"] == 3 and summary["mode"] == mode and summary["seconds"] > 0
        assert sorted(os.listdir(tmp_path / mode)) == [f"{i:08d}_mask.png" for i in range(3)]
        assert cv2.imread(str(tmp_path / mode / "00000000_mask.png"), 0).shape == (96, 96)


def test_dicom_slices_are_served_at_their_size(tmp_path, checkpoints):
    d = tmp_path / "dcm"
    d.mkdir()
    write_dicom(str(d / "a.dcm"), np.random.default_rng(8).integers(0, 4096, size=(48, 40)).astype(np.uint16))
    summary = tpredict.run(["--checkpoint", checkpoints[1], "--images_dir", str(d), "--device", "cpu",
                            "--dataset", "DECATHLON_HEART", "--image_size", "64", "--num_workers", "1",
                            "--output_dir", str(tmp_path / "m")])
    assert summary["images"] == 1 and os.listdir(tmp_path / "m") == ["a_mask.png"]
    assert cv2.imread(str(tmp_path / "m" / "a_mask.png"), 0).shape == (48, 40)


def test_predict_fn_with_windows_matches_jax():
    """The serving function with two HU windows (2 input channels), f32:
    at least 99.9% of mask pixels agree."""
    windows = ((0.4, 0.5), (0.7, 0.3))
    jt = JaxSegTask(arch="resnet18", in_channels=2, dtype=jnp.float32)
    state = jax.device_get(jt.init(jax.random.key(2), (2, 64, 64, 2)))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    imgs = np.random.default_rng(9).integers(0, 256, size=(3, 64, 64, 1), dtype=np.uint8)
    want = np.asarray(jserve.make_predict_fn(jt, variables, 0.2, 0.25, threshold=0.4, fp32=True,
                                             hu_windows=windows)(jnp.asarray(imgs)))
    task = SegmentationTask(in_channels=2, dtype=torch.float32)
    task.model.load_state_dict(unet_flax_to_state_dict(state.params, state.batch_stats))
    got = tserve.make_predict_fn(task, 0.2, 0.25, threshold=0.4, hu_windows=windows)(torch.from_numpy(imgs)).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (3, 64, 64, 1)
    assert 0.01 < want.mean() < 0.99 and (got == want).mean() >= 0.999


def test_sliding_window_of_one_window_is_the_plain_forward(checkpoints):
    """One window blended is the forward itself, to 1e-5 of the largest
    logit: the window batch is padded to 16 and a convolution sums in
    another order at batch 16 than at batch 1 (3.8e-6 here)."""
    task = SegmentationTask(dtype=torch.float32)
    task.model.load_state_dict(torch.load(os.path.join(checkpoints[1], "1.pt"), weights_only=True)["model"])
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 64, 1)).astype(np.float32))
    got = tsw.sliding_window_predict(tsw.make_unet_window_fn(task), x, 64)
    want = task.logits(x[None])[0]
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", [(5, 7), (4, 9, 1), (6, 3, 3), (1, 1)])
def test_png_writer_decodes_under_opencv(tmp_path, shape):
    img = np.random.default_rng(6).integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = img[..., ::-1] if img.ndim == 3 and img.shape[2] == 3 else img.reshape(shape[:2])
    np.testing.assert_array_equal(got, want)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()), img.reshape(want.shape))


def test_png_writer_refuses_other_inputs():
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="takes"):
        encode_png(np.zeros((2, 2, 2), np.uint8))
    ok, buf = cv2.imencode(".png", np.arange(64, dtype=np.uint8).reshape(8, 8))  # OpenCV filters its rows
    assert ok
    with pytest.raises(ValueError, match="filter type 0"):
        decode_png(buf.tobytes())


def test_mask_overlay_and_grid_files_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    gray = rng.integers(0, 256, size=(20, 30), dtype=np.uint8)
    mask = (rng.random((20, 30)) < 0.5).astype(np.uint8)
    for fn in ("_write_mask", "_write_overlay"):
        args = (mask,) if fn == "_write_mask" else (gray, mask)
        getattr(jpredict, fn)(str(tmp_path / "j.png"), *args)
        getattr(tpredict, fn)(str(tmp_path / "t.png"), *args)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_UNCHANGED),
                                      cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED), err_msg=fn)
    imgs = rng.integers(0, 256, size=(5, 16, 16, 1), dtype=np.uint8)
    pred, true = rng.random((5, 16, 16, 1)) < 0.5, rng.random((5, 16, 16, 1)) < 0.5
    jviz.save_combined_image_grid(imgs, pred, true, str(tmp_path / "jg.png"), nrow=3)
    tviz.save_combined_image_grid(imgs, pred, true, str(tmp_path / "tg.png"), nrow=3)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "tg.png")), cv2.imread(str(tmp_path / "jg.png")))
