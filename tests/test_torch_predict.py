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
    with pytest.raises(SystemExit, match="--dataset: baked into the artifact"):
        tpredict.main(["--exported", "m.misx", "--images_dir", str(tmp_path), *base])
    with pytest.raises(SystemExit, match="exactly one of --checkpoint / --exported"):
        tpredict.main(["--images_dir", str(tmp_path), *base])
    with pytest.raises(SystemExit, match="exactly one of --checkpoint / --exported"):
        tpredict.main(["--exported", "m.misx", "--checkpoint", checkpoints[1], "--images_dir", str(tmp_path), *base])
    with pytest.raises(SystemExit, match="--sliding_window needs --checkpoint"):
        tpredict.main(["--exported", "m.misx", "--images_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"),
                       "--device", "cpu", "--sliding_window", "64"])
    with pytest.raises(FileNotFoundError, match="m.misx"):
        tpredict.main(["--exported", str(tmp_path / "m.misx"), "--images_dir", str(tmp_path), "--output_dir",
                       str(tmp_path / "o"), "--device", "cpu"])
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
    task = SegmentationTask(in_channels=2, dtype=torch.float32, device="cpu")
    task.model.load_state_dict(unet_flax_to_state_dict(state.params, state.batch_stats))
    got = tserve.make_predict_fn(task, 0.2, 0.25, threshold=0.4, hu_windows=windows)(torch.from_numpy(imgs)).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (3, 64, 64, 1)
    assert 0.01 < want.mean() < 0.99 and (got == want).mean() >= 0.999


def test_sliding_window_of_one_window_is_the_plain_forward(checkpoints):
    """One window blended is the forward itself, to 1e-5 of the largest
    logit: the window batch is padded to 16 and a convolution sums in
    another order at batch 16 than at batch 1 (3.8e-6 here)."""
    task = SegmentationTask(dtype=torch.float32, device="cpu")
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
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    ok, buf = cv2.imencode(".png", img)  # OpenCV filters its rows: read since the decoder knows every filter
    assert ok
    np.testing.assert_array_equal(decode_png(buf.tobytes()), img)
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(_png_bytes(img, 0, 8, 0, interlace=1))
    with pytest.raises(ValueError, match="unknown filter type 7"):
        decode_png(_png_bytes(img, 0, 8, 7))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="holds .* bytes"):
        decode_png(_png_bytes(img, 0, 8, 0, drop_rows=1))


def _filter_rows(rows, kind, bpp):
    """PNG-filter (h, stride) uint8 rows: ``kind`` 0-4 for every row, 5
    cycles through all five, 7 writes an invalid type byte."""
    h, stride = rows.shape
    out = np.zeros((h, stride + 1), np.uint8)
    prev = np.zeros(stride, np.int64)
    zeros = np.zeros(bpp, np.int64)
    for y in range(h):
        cur = rows[y].astype(np.int64)
        k = y % 5 if kind == 5 else kind
        left, upleft = np.concatenate([zeros, cur[:-bpp]]), np.concatenate([zeros, prev[:-bpp]])
        if k == 1:
            f = cur - left
        elif k == 2:
            f = cur - prev
        elif k == 3:
            f = cur - (left + prev) // 2
        elif k == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            f = cur
        out[y, 0], out[y, 1:] = k, f & 255
        prev = cur
    return out


def _png_bytes(img, ctype, depth, kind, palette=None, trns=None, interlace=0, drop_rows=0):
    """A PNG of ``img`` ((H, W) or (H, W, C) samples) written by hand with
    the row filter ``kind``, split over two IDAT chunks."""
    import struct
    import zlib

    from medical_image_segmentation_tpu_torch.utils.png import _SIGNATURE, _chunk

    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    if depth == 16:
        rows = img.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        rows = img.reshape(h, -1).astype(np.uint8)
    else:
        bits = ((img.reshape(h, w, 1) >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8).reshape(h, -1)
        rows = np.packbits(bits, axis=1)
    body = zlib.compress(_filter_rows(rows, kind, max(1, c * depth // 8))[:h - drop_rows].tobytes())
    out = _SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns.tobytes())
    half = len(body) // 2
    return out + _chunk(b"IDAT", body[:half]) + _chunk(b"IDAT", body[half:]) + _chunk(b"IEND", b"")


_PNG_KINDS = {"gray": (0, 1), "rgb": (2, 3), "palette": (3, 1), "gray_alpha": (4, 2), "rgba": (6, 4)}


@pytest.mark.parametrize("kind", range(6), ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("color,depth", [("gray", 8), ("gray", 16), ("gray", 1), ("gray", 4), ("rgb", 8), ("rgb", 16),
                                         ("palette", 8), ("palette", 2), ("gray_alpha", 8), ("rgba", 8),
                                         ("rgba", 16)])
def test_png_decoder_and_slice_loader_match_opencv(tmp_path, monkeypatch, kind, color, depth):
    """``decode_png`` gives OpenCV's pixels for every row filter, bit depth
    and colour type, and ``_load_slice`` without OpenCV gives the slice it
    gives with it (the fixed-point BT.601 gray, 16 bit / 256)."""
    ctype, c = _PNG_KINDS[color]
    rng = np.random.default_rng(100 * kind + depth + ctype)
    h, w = 11, 19
    img = rng.integers(0, 1 << depth, size=(h, w) if c == 1 else (h, w, c)).astype(np.uint16 if depth == 16
                                                                                   else np.uint8)
    palette = rng.integers(0, 256, size=(1 << depth, 3), dtype=np.uint8) if color == "palette" else None
    trns = rng.integers(0, 256, size=3, dtype=np.uint8) if color == "palette" and depth == 8 else None
    data = _png_bytes(img, ctype, depth, kind, palette, trns)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert want is not None
    got = decode_png(data)
    assert got.dtype == want.dtype
    if want.ndim == 2:
        np.testing.assert_array_equal(got, want)
    elif got.shape[2] == 2:  # OpenCV expands gray+alpha to BGRA
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_array_equal(got[..., 1], want[..., 3])
    else:
        np.testing.assert_array_equal(got[..., [2, 1, 0] + [3] * (got.shape[2] - 3)], want)
    with_cv2 = tpredict._load_slice(path)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)  # import cv2 now raises ImportError
    without = tpredict._load_slice(path)
    assert without.dtype == np.uint8 and without.shape == (h, w)
    np.testing.assert_array_equal(without, with_cv2)


def test_slice_loader_without_opencv_refuses_jpeg_by_name(tmp_path, monkeypatch):
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, np.zeros((8, 8), np.uint8))
    assert tpredict._load_slice(path).shape == (8, 8)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ValueError, match="needs OpenCV"):
        tpredict._load_slice(path)


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
