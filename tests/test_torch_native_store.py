"""The port's native store reader (``medical_image_segmentation_tpu_torch/
csrc/``: ``mis_loader.cpp`` on its own JPEG and PNG decoders) against the
JAX package's native reader (libjpeg-turbo and libpng) and the port's
Python reader, on the CPU.

Stores are written from a seed with the port's writers, ``cv2.imencode``
and a PNG writer in this file (every colour type, bit depth, row filter
and Adam7). ``fetch`` must equal both readers to the byte; ``fetch_views``
must equal the Python route (``fetch_views_fallback``) to the byte on any
windows, and the JAX reader on windows whose taps are exact in float32
(its build lets g++ fuse the bilinear lerp into FMAs, so its views move by
one level on a few pixels elsewhere). Damaged payloads must give the JAX
reader's return code (and, where it decodes them, its pixels). Streams
the port's decoders do not carry raise ``NativeUnsupported`` by name.
The JPEG-LS, DICOM JPEG Lossless and JPEG 2000 entry points of both
libraries agree, and the port's library is built from its own ``csrc/``
and needs no library beyond the C and C++ runtimes.
"""

import ctypes
import os
import re
import struct
import zlib

import cv2
import numpy as np
import pytest

from medical_image_segmentation_tpu.data.store import native as jax_native
from medical_image_segmentation_tpu_torch.data import dicom_codecs, jpeg2000_encode, jpegls
from medical_image_segmentation_tpu_torch.data.host_precrop import fetch_views_fallback, make_view_params
from medical_image_segmentation_tpu_torch.data.store import CODEC_JLS, CODEC_JPEG, CODEC_PNG, CODEC_RAW
from medical_image_segmentation_tpu_torch.data.store import StoreReader, StoreWriter
from medical_image_segmentation_tpu_torch.data.store import native as port_native


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert port_native.get_lib() is not None, "the port's native library did not build"
    assert jax_native.get_lib() is not None, "the JAX package's native library did not build"


def write(path, payloads, codec, channels, dtype=np.uint8):
    """A store of pre-encoded payloads; payloads are (bytes, h, w)."""
    with StoreWriter(str(path), channels=channels, with_labels=True, dtype=dtype) as w:
        for i, (data, h, wd) in enumerate(payloads):
            w.add_encoded(data, h, wd, label=i, codec=codec)
    return str(path)


def fetch_both(path, out_hw=None):
    """(port, jax) results of fetch over the whole store: arrays, or the
    return code of the error each raised."""
    got = []
    for mod in (port_native, jax_native):
        store = mod.NativeStore(path)
        try:
            got.append(store.fetch(np.arange(store.num_samples), out_hw=out_hw, num_threads=3))
        except IOError as e:
            got.append(int(str(e).split("error ")[1].split(":")[0]))
        finally:
            store.close()
    return got


def python_images(path):
    reader = StoreReader(path)
    try:
        return np.stack([reader.image(i) for i in range(len(reader))])
    finally:
        reader.close()


def assert_equal_three(path, python=True):
    port, ref = fetch_both(path)
    assert not isinstance(ref, int), f"the JAX reader failed with {ref}"
    assert not isinstance(port, int), f"the port's reader failed with {port}"
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])
    if python:
        np.testing.assert_array_equal(port[0], python_images(path))
    return port[0]


# ---------------------------------------------------------------------------
# a PNG writer: any colour type, depth, filters, Adam7 and extra chunks
# ---------------------------------------------------------------------------

_ADAM7 = [(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)]


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_rows(rows, bpp, first_kind):
    """Rows of bytes → filtered stream, filter type cycling 0..4."""
    out, prior = bytearray(), bytes(len(rows[0]))
    for y, row in enumerate(rows):
        kind = (first_kind + y) % 5
        f = bytearray(len(row))
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
            f[i] = (x - pred) & 0xFF
        out += bytes([kind]) + f
        prior = row
    return bytes(out)


def _pack(samples, depth):
    """(h, w, ch) integer samples → rows of bytes."""
    h = samples.shape[0]
    if depth == 16:
        return [samples[y].astype(">u2").tobytes() for y in range(h)]
    if depth == 8:
        return [samples[y].astype(np.uint8).tobytes() for y in range(h)]
    rows = []
    for y in range(h):
        bits = np.unpackbits(samples[y, :, 0].astype(np.uint8)[:, None], axis=1)[:, 8 - depth:]
        rows.append(np.packbits(bits.reshape(-1)).tobytes())
    return rows


def make_png(samples, depth, ctype, interlace=False, chunks=b"", first_kind=0):
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        data = b""
        for y0, x0, ys, xs in _ADAM7:
            sub = samples[y0::ys, x0::xs]
            if sub.size:
                data += _filter_rows(_pack(sub, depth), bpp, first_kind)
    else:
        data = _filter_rows(_pack(samples, depth), bpp, first_kind)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + chunks + _chunk(b"IDAT", zlib.compress(data, 6))
            + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# fetch: every codec and layout
# ---------------------------------------------------------------------------


def _smooth(rng, h, w, c=1):
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([127 + 60 * np.sin(xx / (5 + k) + rng.uniform(0, 6)) + 50 * np.cos(yy / (7 + k))
                    + rng.normal(0, 9, (h, w)) for k in range(c)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("channels,dtype", [(1, np.uint8), (3, np.uint8), (1, np.uint16)])
def test_raw_stores(tmp_path, channels, dtype):
    rng = np.random.default_rng(0)
    hi = 65536 if dtype == np.uint16 else 256
    imgs = rng.integers(0, hi, size=(5, 37, 29, channels)).astype(dtype)
    with StoreWriter(str(tmp_path / "s.mis"), channels=channels, dtype=dtype) as w:
        for im in imgs:
            w.add(im, codec=CODEC_RAW)
    got = assert_equal_three(str(tmp_path / "s.mis"))
    np.testing.assert_array_equal(got, imgs)


@pytest.mark.parametrize("restart", [0, 4])
@pytest.mark.parametrize("size", [(256, 256), (173, 250)])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_gray_jpeg(tmp_path, quality, size, restart):
    rng = np.random.default_rng(quality + size[0] + restart)
    payloads = []
    for _ in range(4):
        img = _smooth(rng, *size)[..., 0]
        params = [cv2.IMWRITE_JPEG_QUALITY, quality] + ([cv2.IMWRITE_JPEG_RST_INTERVAL, restart] if restart else [])
        ok, buf = cv2.imencode(".jpg", img, params)
        payloads.append((buf.tobytes(), *size))
    got = assert_equal_three(write(tmp_path / "j.mis", payloads, CODEC_JPEG, 1))
    assert got.shape == (4, *size, 1)


_SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("sampling", sorted(_SAMPLING))
def test_rgb_jpeg(tmp_path, sampling, channels):
    """Three-component YCbCr (as cv2 writes it for imagefolder stores) read
    as RGB (fancy upsampling, jdcolor.c) and as gray (the Y plane)."""
    rng = np.random.default_rng(len(sampling) + channels)
    payloads = []
    for size in ((64, 64), (173, 250), (37, 2), (9, 3)):
        img = _smooth(rng, *size, c=3)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80,
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[sampling]])
        payloads.append((buf.tobytes(), *size))
    for i, payload in enumerate(payloads):
        path = write(tmp_path / f"rgb{i}.mis", [payload], CODEC_JPEG, channels)
        got = assert_equal_three(path, python=channels == 3)
        if channels == 1:
            want = cv2.imdecode(np.frombuffer(payload[0], np.uint8), cv2.IMREAD_GRAYSCALE)
            np.testing.assert_array_equal(got[0, ..., 0], want)


def test_gray_jpeg_read_as_rgb(tmp_path):
    rng = np.random.default_rng(4)
    ok, buf = cv2.imencode(".jpg", _smooth(rng, 40, 52)[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 90])
    got = assert_equal_three(write(tmp_path / "g.mis", [(buf.tobytes(), 40, 52)], CODEC_JPEG, 3), python=False)
    assert (got[..., 0] == got[..., 2]).all()


def _png_cases():
    rng = np.random.default_rng(7)
    g8 = rng.integers(0, 256, (23, 31))
    rgb = rng.integers(0, 256, (23, 31, 3))
    rgba = rng.integers(0, 256, (23, 31, 4))
    g16 = rng.integers(0, 65536, (23, 31))
    rgb16 = rng.integers(0, 65536, (23, 31, 3))
    idx4 = rng.integers(0, 16, (23, 31))
    plte = _chunk(b"PLTE", rng.integers(0, 256, 12 * 3).astype(np.uint8).tobytes())  # 12 of 16 entries
    trns = _chunk(b"tRNS", bytes(range(0, 240, 20)))
    gama = _chunk(b"gAMA", struct.pack(">I", 45455))
    srgb = _chunk(b"sRGB", b"\x00")
    cases = {
        "gray8": (make_png(g8, 8, 0), 1, np.uint8),
        "gray8_as_rgb": (make_png(g8, 8, 0, first_kind=2), 3, np.uint8),
        "rgb": (make_png(rgb, 8, 2), 3, np.uint8),
        "rgb_as_gray": (make_png(rgb, 8, 2, first_kind=3), 1, np.uint8),
        "rgb_as_gray_gamma": (make_png(rgb, 8, 2, chunks=gama), 1, np.uint8),
        "rgb_as_gray_srgb": (make_png(rgb, 8, 2, chunks=srgb), 1, np.uint8),
        "rgba": (make_png(rgba, 8, 6), 3, np.uint8),
        "rgba_as_gray": (make_png(rgba, 8, 6, first_kind=4), 1, np.uint8),
        "gray_alpha": (make_png(np.stack([g8, g8[::-1]], -1), 8, 4), 1, np.uint8),
        "palette_trns": (make_png(idx4, 4, 3, chunks=plte + trns), 3, np.uint8),
        "palette_as_gray": (make_png(idx4, 4, 3, chunks=plte + trns, first_kind=1), 1, np.uint8),
        "gray1": (make_png(g8 & 1, 1, 0), 1, np.uint8),
        "gray2": (make_png(g8 & 3, 2, 0, first_kind=1), 1, np.uint8),
        "gray4": (make_png(g8 & 15, 4, 0, first_kind=4), 1, np.uint8),
        "gray4_adam7": (make_png(g8 & 15, 4, 0, interlace=True), 1, np.uint8),
        "gray8_adam7": (make_png(g8, 8, 0, interlace=True, first_kind=3), 1, np.uint8),
        "rgb_adam7": (make_png(rgb, 8, 2, interlace=True, first_kind=4), 3, np.uint8),
        "gray16_into_u8": (make_png(g16, 16, 0, first_kind=1), 1, np.uint8),
        "rgb16_as_gray_into_u8": (make_png(rgb16, 16, 2, first_kind=2), 1, np.uint8),
        "gray16_into_u16": (make_png(g16, 16, 0, first_kind=4), 1, np.uint16),
        "gray16_adam7_into_u16": (make_png(g16, 16, 0, interlace=True), 1, np.uint16),
    }
    return cases


_PNG = _png_cases()


@pytest.mark.parametrize("case", sorted(_PNG))
def test_png(tmp_path, case):
    data, channels, dtype = _PNG[case]
    path = write(tmp_path / "p.mis", [(data, 23, 31)], CODEC_PNG, channels, dtype)
    # the Python reader returns the file's own channels and dtype: it is held
    # where those are the store's
    python = case in ("gray8", "rgb", "gray1", "gray2", "gray4", "gray4_adam7", "gray8_adam7", "rgb_adam7",
                      "gray16_into_u16", "gray16_adam7_into_u16")
    assert_equal_three(path, python=python)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_jpeg_ls(tmp_path, dtype):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256 if dtype == np.uint8 else 4096, size=(4, 40, 33, 1)).astype(dtype)
    with StoreWriter(str(tmp_path / "l.mis"), channels=1, dtype=dtype) as w:
        for im in imgs:
            w.add(im, codec=CODEC_JLS)
    got = assert_equal_three(str(tmp_path / "l.mis"))
    np.testing.assert_array_equal(got, imgs)


def test_resized_fetch(tmp_path):
    """Samples of other sizes are placed nearest-neighbour into out_hw."""
    rng = np.random.default_rng(5)
    payloads = []
    for size in ((40, 60), (64, 64), (17, 90)):
        ok, buf = cv2.imencode(".jpg", _smooth(rng, *size)[..., 0])
        payloads.append((buf.tobytes(), *size))
    port, ref = fetch_both(write(tmp_path / "m.mis", payloads, CODEC_JPEG, 1), out_hw=(32, 48))
    np.testing.assert_array_equal(port[0], ref[0])


# ---------------------------------------------------------------------------
# fetch_views
# ---------------------------------------------------------------------------


def _view_stores(tmp_path):
    rng = np.random.default_rng(11)
    stores = {}
    for name, (h, w, c) in {"gray": (173, 250, 1), "rgb": (96, 120, 3)}.items():
        imgs = [_smooth(rng, h, w, c) for _ in range(3)]
        jpg = []
        for im in imgs:
            sampling = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420
            ok, buf = cv2.imencode(".jpg", im if c == 3 else im[..., 0],
                                   [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
            jpg.append((buf.tobytes(), h, w))
        stores[f"{name}_jpeg"] = write(tmp_path / f"{name}_j.mis", jpg, CODEC_JPEG, c)
        stores[f"{name}_png"] = write(tmp_path / f"{name}_p.mis",
                                      [(make_png(im, 8, 0 if c == 1 else 2), h, w) for im in imgs], CODEC_PNG, c)
        with StoreWriter(str(tmp_path / f"{name}_r.mis"), channels=c) as wr:
            for im in imgs:
                wr.add(im, codec=CODEC_RAW)
        stores[f"{name}_raw"] = str(tmp_path / f"{name}_r.mis")
    with StoreWriter(str(tmp_path / "jls.mis"), channels=1) as wr:
        for im in range(3):
            wr.add(_smooth(rng, 173, 250)[..., 0], codec=CODEC_JLS)
    stores["gray_jls"] = str(tmp_path / "jls.mis")
    return stores


def _views(mod, path, params, out_hw):
    store = mod.NativeStore(path)
    try:
        return store.fetch_views(np.arange(store.num_samples), params, out_hw, num_threads=2)
    finally:
        store.close()


def _python_views(path, params, out_hw):
    reader = StoreReader(path)
    try:
        return fetch_views_fallback(reader, np.arange(len(reader)), params, out_hw)
    finally:
        reader.close()


@pytest.mark.parametrize("kind", ["gray_jpeg", "rgb_jpeg", "gray_png", "rgb_png", "gray_raw", "rgb_raw", "gray_jls"])
def test_fetch_views_exact_windows(tmp_path, kind):
    """Windows at the corners and across 8- and 16-pixel block edges, with
    scales of 1, 2 and 1/2: the three readers agree to the byte."""
    path = _view_stores(tmp_path)[kind]
    h, w = StoreReader(path).header.height, StoreReader(path).header.width
    windows = [
        [(0, 0, 32, 32, 0), (h - 32, w - 32, 32, 32, 1)],    # the two far corners
        [(7, 15, 16, 16, 0), (h - 16, 0, 16, 16, 1)],         # across block edges
        [(23, 33, 64, 64, 1), (0, w - 64, 64, 64, 0)],       # 2x down
        [(h - 8, 9, 8, 8, 0), (40, 40, 8, 8, 1)],            # 2x up
    ]
    for win in windows[:3] + windows[3:]:
        params = np.array([win] * 3, np.float32)
        out_hw = (32, 32) if win[0][2] != 8 else (16, 16)
        if win[0][2] == 16:
            out_hw = (16, 16)
        port, _ = _views(port_native, path, params, out_hw)
        ref, _ = _views(jax_native, path, params, out_hw)
        py, _ = _python_views(path, params, out_hw)
        np.testing.assert_array_equal(port, ref, err_msg=f"{kind} {win}")
        np.testing.assert_array_equal(port, py, err_msg=f"{kind} {win}")


@pytest.mark.parametrize("kind", ["gray_jpeg", "rgb_jpeg", "gray_png", "gray_raw", "gray_jls"])
def test_fetch_views_random_windows(tmp_path, kind):
    """RandomResizedCrop windows from the trainers' sampler: equal to the
    Python route to the byte (no fused multiply-add in the port's lerp); the
    JAX reader within one level on a few pixels."""
    path = _view_stores(tmp_path)[kind]
    reader = StoreReader(path)
    h, w = reader.header.height, reader.header.width
    reader.close()
    params = make_view_params(3, 0, 1, 3, h, w, n_views=4)
    port, labels = _views(port_native, path, params, (56, 56))
    py, py_labels = _python_views(path, params, (56, 56))
    np.testing.assert_array_equal(port, py)
    np.testing.assert_array_equal(labels, py_labels)
    ref, _ = _views(jax_native, path, params, (56, 56))
    diff = np.abs(port.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())


# ---------------------------------------------------------------------------
# damaged payloads and named refusals
# ---------------------------------------------------------------------------


def _damaged():
    rng = np.random.default_rng(21)
    ok, jpg = cv2.imencode(".jpg", _smooth(rng, 64, 80)[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 90])
    jpg = jpg.tobytes()
    ok, jrst = cv2.imencode(".jpg", _smooth(rng, 64, 80)[..., 0], [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    jrst = jrst.tobytes()
    sos = jpg.index(b"\xff\xda")
    scan = sos + 2 + struct.unpack(">H", jpg[sos + 2:sos + 4])[0]
    flipped = bytearray(jpg)
    for k in range(scan + 40, len(jpg) - 40, 97):
        flipped[k] ^= 0x5A
    png = make_png(rng.integers(0, 256, (20, 24)), 8, 0)
    idat = png.index(b"IDAT")
    bad_crc = bytearray(png)
    bad_crc[idat + 10] ^= 1  # IDAT data changed, CRC left
    bad_filter = make_png(rng.integers(0, 256, (20, 24)), 8, 0)
    raw = zlib.decompress(bad_filter[bad_filter.index(b"IDAT") + 4:-12 - 4])
    bad_filter = (bad_filter[:bad_filter.index(b"IDAT") - 4] + _chunk(b"IDAT", zlib.compress(b"\x07" + raw[1:]))
                  + _chunk(b"IEND", b""))
    z = bytearray(zlib.compress(bytes(21 * 20)))
    z[-1] ^= 1
    bad_adler = (png[:png.index(b"IDAT") - 4] + _chunk(b"IDAT", bytes(z)) + _chunk(b"IEND", b""))
    return {
        "jpeg_truncated_scan": (jpg[:len(jpg) * 3 // 5], CODEC_JPEG),
        "jpeg_truncated_restarts": (jrst[:len(jrst) // 2], CODEC_JPEG),
        "jpeg_truncated_header": (jpg[:scan - 30], CODEC_JPEG),
        "jpeg_no_soi": (b"\x00" + jpg[1:], CODEC_JPEG),
        "jpeg_flipped_bytes": (bytes(flipped), CODEC_JPEG),
        "png_truncated": (png[:len(png) - 20], CODEC_PNG),
        "png_bad_crc": (bytes(bad_crc), CODEC_PNG),
        "png_bad_filter": (bad_filter, CODEC_PNG),
        "png_bad_adler": (bad_adler, CODEC_PNG),
        "png_no_signature": (b"\x88" + png[1:], CODEC_PNG),
        "garbage": (bytes(rng.integers(0, 256, 300).astype(np.uint8)), CODEC_JPEG),
    }


_DAMAGED = _damaged()


@pytest.mark.parametrize("case", sorted(_DAMAGED))
def test_damaged_payloads(tmp_path, case):
    data, codec = _DAMAGED[case]
    size = (64, 80) if codec == CODEC_JPEG else (20, 24)
    port, ref = fetch_both(write(tmp_path / "d.mis", [(data, *size)], codec, 1))
    if isinstance(ref, int):
        assert port == ref, f"port {port}, JAX reader {ref}"
    else:
        assert not isinstance(port, int), f"the JAX reader decodes it, the port returns {port}"
        np.testing.assert_array_equal(port[0], ref[0])


def test_damaged_jls(tmp_path):
    data = jpegls.jpeg_ls_encode(np.random.default_rng(2).integers(0, 256, (30, 30)).astype(np.uint8))
    port, ref = fetch_both(write(tmp_path / "d.mis", [(data[:len(data) // 2], 30, 30)], CODEC_JLS, 1))
    assert port == ref == -9


def test_refused_by_name(tmp_path):
    rng = np.random.default_rng(9)
    img = _smooth(rng, 48, 48)[..., 0]
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    ok, base = cv2.imencode(".jpg", img)
    arith = bytearray(base.tobytes())
    arith[arith.index(b"\xff\xc0") + 1] = 0xC9
    cases = {-11: (prog.tobytes(), CODEC_JPEG, 1),
             -12: (bytes(arith), CODEC_JPEG, 1),
             -15: (make_png(rng.integers(0, 256, (48, 48, 3)), 8, 2, chunks=_chunk(b"cHRM", bytes(32))),
                   CODEC_PNG, 1)}
    for code, (data, codec, channels) in cases.items():
        path = write(tmp_path / f"r{-code}.mis", [(data, 48, 48)], codec, channels)
        store = port_native.NativeStore(path)
        with pytest.raises(port_native.NativeUnsupported) as e:
            store.fetch(np.array([0]))
        assert e.value.code == code and port_native.ERRORS[code] in str(e.value)
        store.close()


def test_loaders_report_the_native_reader(tmp_path):
    """The ``Loader`` serves through the port's library, and the
    segmentation trainer's result says so for its paired stores."""
    from medical_image_segmentation_tpu_torch.data.loader import Loader, PairedLoader
    from medical_image_segmentation_tpu_torch.train.train_segmentation import host_reader

    rng = np.random.default_rng(6)
    payloads = [(cv2.imencode(".jpg", _smooth(rng, 32, 32)[..., 0])[1].tobytes(), 32, 32) for _ in range(4)]
    path = write(tmp_path / "a.mis", payloads, CODEC_JPEG, 1)
    loader = Loader(path, 2, prefetch=0)
    assert isinstance(loader._native, port_native.NativeStore)
    imgs, _ = next(iter(loader))
    np.testing.assert_array_equal(imgs, python_images(path)[:2])
    loader.close()
    paired = PairedLoader(path, path, 2, prefetch=0)
    assert host_reader(paired) == "native"
    paired.close()
    paired = PairedLoader(path, path, 2, prefetch=0, use_native=False)
    assert host_reader(paired) == "python"
    paired.close()


# ---------------------------------------------------------------------------
# the DICOM codecs' entry points through both libraries
# ---------------------------------------------------------------------------


def _decode_with(lib, fn, data, n, ctype):
    out = np.zeros(n, ctype)
    rc = getattr(lib, fn)(data, len(data), out.ctypes.data_as(ctypes.POINTER(np.ctypeslib.as_ctypes_type(ctype))), n)
    return rc, out


@pytest.mark.parametrize("codec", ["jpegls", "jpeg_lossless", "j2k"])
def test_codec_entry_points(codec):
    rng = np.random.default_rng(13)
    img = (1500 + rng.integers(0, 900, (48, 40))).astype(np.uint16)
    libs = (port_native.get_lib(), jax_native.get_lib())
    if codec == "jpegls":
        data = jpegls.jpeg_ls_encode(img, precision=16)
        got = [_decode_with(lib, "jpegls_decode", data, img.size, np.uint16) for lib in libs]
    elif codec == "jpeg_lossless":
        data = dicom_codecs.jpeg_lossless_encode(img, precision=16)
        got = [_decode_with(lib, "jls_decode", data, img.size, np.uint16) for lib in libs]
    else:
        data = jpeg2000_encode.j2k_encode(img)
        got = [_decode_with(lib, "j2k_decode", data, img.size, np.int32) for lib in libs]
    assert got[0][0] == got[1][0] == 0
    np.testing.assert_array_equal(got[0][1], got[1][1])
    np.testing.assert_array_equal(got[0][1].reshape(img.shape), img)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def _needed(path):
    """DT_NEEDED entries of an ELF64 little-endian shared object."""
    with open(path, "rb") as f:
        elf = f.read()
    assert elf[:4] == b"\x7fELF" and elf[4] == 2 and elf[5] == 1
    shoff, = struct.unpack_from("<Q", elf, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", elf, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", elf, shoff + i * shentsize) for i in range(shnum)]
    dynamic = next(s for s in sections if s[1] == 6)  # SHT_DYNAMIC
    strtab = sections[dynamic[6]]  # sh_link
    names = []
    for off in range(dynamic[4], dynamic[4] + dynamic[5], 16):
        tag, val = struct.unpack_from("<qQ", elf, off)
        if tag == 0:
            break
        if tag == 1:  # DT_NEEDED
            start = strtab[4] + val
            names.append(elf[start:elf.index(b"\x00", start)].decode())
    return names


def test_build_uses_only_the_ports_sources_and_runtime():
    info = port_native.build_info()
    cmd = info["command"]
    assert cmd[:6] == ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
    srcs = [a for a in cmd if a.endswith(".cpp")]
    assert {os.path.basename(s) for s in srcs} == {"mis_loader.cpp", "jpeg_decode.cpp", "png_decode.cpp",
                                                   "dicom_codecs.cpp", "jpegls_codec.cpp", "j2k_codec.cpp"}
    assert all(os.path.dirname(s) == port_native.CSRC_DIR for s in srcs)
    assert port_native.CSRC_DIR.endswith(os.path.join("medical_image_segmentation_tpu_torch", "csrc"))
    assert not [a for a in cmd if a.startswith("-l")]
    assert os.path.basename(info["path"]).startswith("libmisloader-torch-")
    allowed = ("libc.so", "libm.so", "libstdc++.so", "libgcc_s.so", "libpthread.so", "ld-linux")
    needed = _needed(info["path"])
    assert needed and all(n.startswith(allowed) for n in needed), needed
    for src in srcs:
        with open(src) as f:
            text = f.read()
        assert not re.search(r'#include\s*[<"](jpeglib|png|zlib)\.h', text), src


def test_both_libraries_load_in_one_process():
    """Each library answers through its own symbols (RTLD_LOCAL)."""
    port, ref = port_native.get_lib(), jax_native.get_lib()
    assert port._name != ref._name
    assert ctypes.cast(port.mis_open, ctypes.c_void_p).value != ctypes.cast(ref.mis_open, ctypes.c_void_p).value
