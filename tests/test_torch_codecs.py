"""The port's image routes without OpenCV or PIL, held against OpenCV and
PIL on the CPU.

- ``utils/resize.py`` against ``cv2.resize``: ``INTER_LINEAR`` and
  ``INTER_NEAREST`` on uint8, ``INTER_AREA`` downscales on uint8 and
  uint16 (integer and non-integer ratios, the 2×2 fast path, odd sizes),
  up- and downscales; and against PIL's ``BICUBIC`` on float32. Equal to
  the pixel (float32 bit for bit for BICUBIC).
- ``utils/jpeg.py`` against ``cv2.imencode`` / ``cv2.imdecode`` at
  qualities 1-100 and sizes that are not multiples of 8: the encoder's
  bytes equal OpenCV's, the decoder's pixels equal OpenCV's, also on
  OpenCV streams with restart markers and optimized Huffman tables.
  Three-channel and progressive streams raise by name.
- 16-bit ``encode_png`` read back by ``cv2.imread(IMREAD_UNCHANGED)``;
  ``png_size`` and ``jpeg_size``.
- ``utils/imageio.py`` against ``cv2.imread`` in both modes on every
  PNG kind.
- The store writer and reader, the Decathlon loader and the DICOM JPEG
  routes with ``cv2`` blocked (``sys.modules["cv2"] = None``), against the
  same calls with it: equal bytes where the tentpole asks for them.
"""

import io
import sys

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from medical_image_segmentation_tpu_torch.data import decathlon as tdec
from medical_image_segmentation_tpu_torch.data import dicom as tdicom
from medical_image_segmentation_tpu_torch.data import dicom_codecs as tcodecs
from medical_image_segmentation_tpu_torch.data.store import CODEC_JPEG, CODEC_PNG, CODEC_RAW, StoreReader
from medical_image_segmentation_tpu_torch.data.store.writer import write_store_from_dataset
from medical_image_segmentation_tpu_torch.utils import imageio, jpeg, png, resize

_FLAGS = {"linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST, "area": cv2.INTER_AREA}


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)


def _image(rng, shape, dtype, kind="noise"):
    top = np.iinfo(dtype).max
    if kind == "noise":
        return rng.integers(0, top + 1, size=shape).astype(dtype)
    y, x = np.mgrid[: shape[0], : shape[1]]
    img = ((np.sin(x / 5.0) + np.cos(y / 7.0) + 2) / 4 * top).astype(dtype)
    return img if len(shape) == 2 else np.repeat(img[..., None], shape[2], axis=2)


# (src h, src w, channels, dst w, dst h)
_RESIZE_CASES = {
    "linear": [(64, 64, 1, 224, 224), (512, 512, 1, 224, 224), (37, 53, 1, 100, 71), (300, 260, 1, 224, 194),
               (97, 61, 3, 40, 33), (80, 80, 1, 40, 40), (33, 47, 1, 33, 90), (5, 3, 1, 17, 9)],
    "nearest": [(64, 64, 1, 224, 224), (512, 512, 1, 224, 224), (37, 53, 1, 100, 71), (19, 23, 3, 7, 5),
                (224, 224, 1, 224, 224), (101, 7, 1, 3, 300)],
    "area": [(300, 300, 1, 224, 224), (512, 512, 1, 224, 224), (448, 448, 1, 224, 224), (672, 336, 1, 224, 112),
             (301, 257, 1, 224, 191), (99, 81, 3, 33, 27), (64, 96, 1, 16, 24), (45, 45, 1, 9, 9),
             (260, 300, 1, 194, 224), (33, 17, 1, 16, 32)],
}


@pytest.mark.parametrize("interp,case,dtype", [
    (k, c, dt) for k, cases in _RESIZE_CASES.items() for c in cases
    for dt in ((np.uint8,) if k == "linear" else (np.uint8, np.uint16))])  # INTER_LINEAR: the loaders' uint8
def test_resize_equals_opencv(interp, case, dtype):
    sh, sw, c, dw, dh = case
    rng = np.random.default_rng(sh * 1000 + sw)
    shape = (sh, sw) if c == 1 else (sh, sw, c)
    for kind in ("noise", "smooth"):
        img = _image(rng, shape, dtype, kind)
        want = cv2.resize(img, (dw, dh), interpolation=_FLAGS[interp])
        got = resize.resize_numpy(img, (dw, dh), interp)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(sh=st.integers(2, 120), sw=st.integers(2, 120), dh=st.integers(1, 150), dw=st.integers(1, 150),
       interp=st.sampled_from(["linear", "nearest", "area"]), seed=st.integers(0, 2**16))
def test_resize_equals_opencv_on_random_sizes(sh, sw, dh, dw, interp, seed):
    if interp == "area":
        dh, dw = min(dh, sh), min(dw, sw)  # the numpy INTER_AREA route downscales
    img = np.random.default_rng(seed).integers(0, 256, size=(sh, sw)).astype(np.uint8)
    np.testing.assert_array_equal(resize.resize_numpy(img, (dw, dh), interp),
                                  cv2.resize(img, (dw, dh), interpolation=_FLAGS[interp]))


def test_resize_refuses_what_it_does_not_carry(no_cv2):
    with pytest.raises(NotImplementedError, match="downscales only"):
        resize.resize(np.zeros((4, 4), np.uint8), (8, 8), "area")
    with pytest.raises(NotImplementedError, match="uint8"):
        resize.resize(np.zeros((4, 4), np.float32), (8, 8), "linear")
    with pytest.raises(ValueError, match="interpolation"):
        resize.resize(np.zeros((4, 4), np.uint8), (8, 8), "cubic")


@pytest.mark.parametrize("src,dst", [((300, 300), (224, 224)), ((512, 260), (224, 114)), ((260, 512), (114, 224)),
                                     ((30, 40), (60, 80)), ((77, 91), (77, 45)), ((768, 700), (224, 204))])
def test_pil_bicubic_equals_pil(src, dst):
    rng = np.random.default_rng(src[0])
    arr = rng.random(src).astype(np.float32)
    want = np.asarray(Image.fromarray(arr).resize((dst[1], dst[0]), Image.BICUBIC), np.float32)
    got = resize.pil_bicubic_numpy(arr, (dst[1], dst[0]))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_resize_dispatch_without_opencv_is_the_numpy_route(no_cv2):
    img = np.random.default_rng(3).integers(0, 65536, size=(300, 280)).astype(np.uint16)
    want = cv2.resize(img, (224, 209), interpolation=cv2.INTER_AREA)  # the module bound before the block
    np.testing.assert_array_equal(resize.resize(img, (224, 209), "area"), want)
    arr = img.astype(np.float32) / 65535
    np.testing.assert_array_equal(resize.pil_bicubic(arr, (224, 209)), resize.pil_bicubic_numpy(arr, (224, 209)))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [50, 75, 90, 95, 100])
@pytest.mark.parametrize("size", [(224, 224), (37, 53), (1, 1), (8, 17), (101, 9)])
def test_jpeg_encoder_bytes_equal_opencv(quality, size):
    rng = np.random.default_rng(quality + size[0])
    for kind in ("noise", "smooth"):
        img = _image(rng, size, np.uint8, kind)
        ok, want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok
        assert jpeg.encode_jpeg_numpy(img, quality) == want.tobytes()


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(1, 100), seed=st.integers(0, 2**16))
def test_jpeg_codec_equals_opencv_on_random_images(h, w, quality, seed):
    img = np.random.default_rng(seed).integers(0, 256, size=(h, w)).astype(np.uint8)
    ok, want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert jpeg.encode_jpeg_numpy(img, quality) == want.tobytes()
    np.testing.assert_array_equal(jpeg.decode_jpeg_numpy(want.tobytes()),
                                  cv2.imdecode(want, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("params", [[], [cv2.IMWRITE_JPEG_OPTIMIZE, 1], [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
                                    [cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 1]])
@pytest.mark.parametrize("quality", [50, 85, 100])
def test_jpeg_decoder_equals_opencv(params, quality):
    rng = np.random.default_rng(quality)
    for size, kind in (((224, 224), "smooth"), ((61, 45), "noise")):
        img = _image(rng, size, np.uint8, kind)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality] + params)
        np.testing.assert_array_equal(jpeg.decode_jpeg_numpy(buf.tobytes()), cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))


def test_jpeg_refuses_what_it_does_not_read(tmp_path, no_cv2):
    rgb = np.random.default_rng(0).integers(0, 256, size=(16, 16, 3)).astype(np.uint8)
    with pytest.raises(jpeg.JpegError, match="three-channel JPEG needs OpenCV"):
        jpeg.encode_jpeg(rgb, 90)  # the dispatcher, OpenCV blocked
    ok, color = cv2.imencode(".jpg", rgb)
    with pytest.raises(jpeg.JpegUnsupported, match="three-channel JPEG needs OpenCV"):
        jpeg.decode_jpeg_numpy(color.tobytes())
    ok, prog = cv2.imencode(".jpg", rgb[..., 0], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(jpeg.JpegUnsupported, match="progressive"):
        jpeg.decode_jpeg_numpy(prog.tobytes())
    with pytest.raises(jpeg.JpegError, match="not a JPEG"):
        jpeg.decode_jpeg_numpy(b"\x89PNG....")
    # through the file reader: what cannot be served raises, what is malformed reads as None (cv2.imread)
    for name, data in (("color.jpg", color), ("prog.jpg", prog)):
        (tmp_path / name).write_bytes(data.tobytes())
        with pytest.raises(jpeg.JpegUnsupported):
            imageio.read_image(str(tmp_path / name))
    (tmp_path / "bad.jpg").write_bytes(color.tobytes()[:40] + b"\x00" * 8)
    assert imageio.read_image(str(tmp_path / "bad.jpg")) is None


def test_jpeg_size_reads_headers_only(tmp_path):
    img = np.zeros((37, 53), np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert jpeg.jpeg_size(io.BytesIO(buf.tobytes())) == (37, 53)
    path = tmp_path / "x.jpg"
    path.write_bytes(buf.tobytes()[:200])  # truncated after the frame header
    with open(path, "rb") as f:
        assert jpeg.jpeg_size(f) == (37, 53)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert jpeg.jpeg_size(io.BytesIO(prog.tobytes())) == (37, 53)


# ---------------------------------------------------------------------------
# PNG and image files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((31, 17), np.uint16), ((1, 1), np.uint16), ((9, 300), np.uint16),
                                         ((31, 17), np.uint8), ((5, 7, 3), np.uint8)])
def test_encode_png_reads_back_through_opencv(tmp_path, shape, dtype):
    img = np.random.default_rng(shape[0]).integers(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img if img.ndim == 2 else img[..., ::-1])
    assert png.png_size(path) == shape[:2]
    with pytest.raises(ValueError, match="gray images only"):
        png.encode_png(np.zeros((2, 2, 3), np.uint16))


@pytest.mark.parametrize("kind", ["g8", "g16", "c8", "c16", "a8", "a16", "ga8"])
@pytest.mark.parametrize("gray", [False, True])
def test_read_image_equals_opencv(tmp_path, kind, gray, monkeypatch):
    rng = np.random.default_rng(len(kind))
    dtype = np.uint16 if "16" in kind else np.uint8
    channels = {"g": 1, "c": 3, "a": 4, "ga": 2}[kind.rstrip("0123456789")]
    shape = (23, 29) if channels == 1 else (23, 29, channels)
    img = rng.integers(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)
    if channels >= 3:
        img[:5, :, :3] = img[:5, :, :1]  # some gray pixels (libpng keeps them as they are)
    path = str(tmp_path / f"{kind}.png")
    if channels == 2:
        Image.fromarray(img, "LA").save(path)
    else:
        cv2.imwrite(path, img)
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_UNCHANGED)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = imageio.read_image(path, gray=gray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert imageio.read_image(str(tmp_path / "missing.png")) is None


def test_write_image_without_opencv(tmp_path, no_cv2):
    bgr = np.random.default_rng(1).integers(0, 256, size=(6, 5, 3)).astype(np.uint8)
    assert imageio.write_image(str(tmp_path / "c.png"), bgr)
    assert imageio.read_image(str(tmp_path / "c.png")).tolist() == bgr.tolist()
    with pytest.raises(ValueError, match="PNG only"):
        imageio.write_image(str(tmp_path / "c.jpg"), bgr)


# ---------------------------------------------------------------------------
# stores, loaders, DICOM with cv2 blocked
# ---------------------------------------------------------------------------

class _Images:
    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i]


def _store_bytes(path, images, codec, dtype=np.uint8, max_resolution=None, channels=1):
    write_store_from_dataset(path, _Images(images), channels=channels, codec=codec, quality=90,
                             max_resolution=max_resolution, dtype=dtype)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("codec,dtype,max_res", [(CODEC_JPEG, np.uint8, 224), (CODEC_JPEG, np.uint8, None),
                                                 (CODEC_PNG, np.uint8, 224), (CODEC_PNG, np.uint16, 224),
                                                 (CODEC_RAW, np.uint16, 160)])
def test_store_without_opencv_equals_store_with_it(tmp_path, monkeypatch, codec, dtype, max_res):
    rng = np.random.default_rng(codec)
    images = [_image(rng, shape, dtype, kind)[..., None]
              for shape, kind in (((300, 260), "smooth"), ((224, 224), "noise"), ((97, 301), "smooth"))]
    with_cv2 = _store_bytes(str(tmp_path / "a.mis"), images, codec, dtype, max_res)
    want = [StoreReader(str(tmp_path / "a.mis")).image(i) for i in range(3)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    without = _store_bytes(str(tmp_path / "b.mis"), images, codec, dtype, max_res)
    if codec != CODEC_PNG:  # JPEG and raw: the same bytes
        assert without == with_cv2
    reader = StoreReader(str(tmp_path / "b.mis"))
    for i in range(3):
        got = reader.image(i)
        assert got.dtype == want[i].dtype
        np.testing.assert_array_equal(got, want[i])


def test_store_refuses_color_jpeg_without_opencv(tmp_path, no_cv2):
    rgb = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(jpeg.JpegError, match="three-channel JPEG needs OpenCV"):
        _store_bytes(str(tmp_path / "c.mis"), [rgb], CODEC_JPEG, channels=3)


def test_decathlon_loader_without_opencv_equals_with_it(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    img_dir, msk_dir = tmp_path / "images", tmp_path / "masks"
    img_dir.mkdir()
    msk_dir.mkdir()
    for v in range(2):
        for s in range(3):
            size = (64, 64) if v == 0 else (90, 70)
            cv2.imwrite(str(img_dir / f"la_{v:03d}_{s}.png"), _image(rng, size, np.uint8, "smooth"))
            cv2.imwrite(str(msk_dir / f"la_{v:03d}_{s}.png"), ((rng.random(size) > 0.7) * 255).astype(np.uint8))

    def batches():
        ds = tdec.DecathlonDataset(str(img_dir), str(msk_dir))
        loader = tdec.DecathlonLoader(ds, batch_size=3, image_size=224, shuffle=True, seed=1)
        return [b for b in loader]

    want = batches()
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = batches()
    assert len(got) == len(want) == 2
    for (gi, gm), (wi, wm) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


def test_dicom_baseline_jpeg_without_opencv(tmp_path, monkeypatch):
    arr = _image(np.random.default_rng(5), (40, 36), np.uint8, "smooth")
    tdicom.write_dicom(str(tmp_path / "a.dcm"), arr, transfer_syntax=tdicom.JPEG_BASELINE)
    want = tdicom.read_dicom(str(tmp_path / "a.dcm")).pixel_array
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    tdicom.write_dicom(str(tmp_path / "b.dcm"), arr, transfer_syntax=tdicom.JPEG_BASELINE)
    assert (tmp_path / "b.dcm").read_bytes() == (tmp_path / "a.dcm").read_bytes()
    np.testing.assert_array_equal(tdicom.read_dicom(str(tmp_path / "b.dcm")).pixel_array, want)
    ok, buf = cv2.imencode(".jpg", arr, [cv2.IMWRITE_JPEG_QUALITY, 70])
    np.testing.assert_array_equal(tcodecs.jpeg_baseline_decode(buf.tobytes()),
                                  cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
    with pytest.raises(tcodecs.CodecError, match="JPEG baseline decode failed"):
        tcodecs.jpeg_baseline_decode(cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))[1].tobytes())
