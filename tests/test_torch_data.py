"""The port's own copies of the JAX package's host code against the
originals, on the CPU, and the two rules that keep the port standing alone.

- MIS store, both directions (port writes, JAX reads; JAX writes, port
  reads) for uint8 C=1, uint8 C=3 and uint16 C=1, raw and JPEG-LS: equal
  arrays and labels.
- ``Loader`` (every order mode, a resizing ``out_hw`` and the host
  pre-crop) and ``PairedLoader`` through the Python reader: the same
  batch order and the same bytes over two epochs.
- Decathlon PNG dataset and loader on a tiny synthetic tree: the same
  names, items and batches.
- ``read_dicom`` on files written here, uncompressed and JPEG-LS: equal
  pixel arrays.
- ``Registry``, ``CSVMetricsLogger`` (byte-equal CSV) and the viz grid.
- Importing every module of the port and ``chip_smoke`` loads neither
  ``jax`` nor any module of ``medical_image_segmentation_tpu``.
- ``BYOLTask`` and ``SegmentationTask`` default to the card and raise
  without one.
"""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.core import metrics_logger as jlog
from medical_image_segmentation_tpu.core import registry as jreg
from medical_image_segmentation_tpu.data import datamodules as jdm
from medical_image_segmentation_tpu.data import decathlon as jdec
from medical_image_segmentation_tpu.data import dicom as jdicom
from medical_image_segmentation_tpu.data import loader as jloader
from medical_image_segmentation_tpu.data import store as jstore
from medical_image_segmentation_tpu.utils import viz as jviz
from medical_image_segmentation_tpu_torch.core import metrics_logger as tlog
from medical_image_segmentation_tpu_torch.core import registry as treg
from medical_image_segmentation_tpu_torch.data import datamodules as tdm
from medical_image_segmentation_tpu_torch.data import decathlon as tdec
from medical_image_segmentation_tpu_torch.data import dicom as tdicom
from medical_image_segmentation_tpu_torch.data import loader as tloader
from medical_image_segmentation_tpu_torch.data import store as tstore
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask
from medical_image_segmentation_tpu_torch.utils import viz as tviz
from medical_image_segmentation_tpu_torch.utils.png import decode_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jstore, "port": tstore}


def _samples(dtype, channels, n=5, seed=0):
    rng = np.random.default_rng(seed)
    hi = 4096 if dtype == np.uint16 else 256  # CT-like 12-bit range in u16
    return [rng.integers(0, hi, size=(20 + 2 * i, 24, channels)).astype(dtype) for i in range(n)]


def _write(pkg, path, imgs, codec):
    with pkg.StoreWriter(path, channels=imgs[0].shape[-1], with_labels=True, dtype=imgs[0].dtype) as w:
        for i, img in enumerate(imgs):
            w.add(img, label=3 * i + 1, codec=codec)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("codec", ["raw", "jls"])
@pytest.mark.parametrize("dtype,channels", [(np.uint8, 1), (np.uint8, 3), (np.uint16, 1)])
def test_store_round_trip_across_packages(tmp_path, writer, reader, codec, dtype, channels):
    imgs = _samples(dtype, channels)
    path = str(tmp_path / "s.mis")
    code = {"raw": jstore.CODEC_RAW, "jls": jstore.CODEC_JLS}[codec]
    assert code == {"raw": tstore.CODEC_RAW, "jls": tstore.CODEC_JLS}[codec]
    _write(PACKAGES[writer], path, imgs, code)
    r = PACKAGES[reader].StoreReader(path)
    try:
        assert len(r) == len(imgs) and r.header.sample_dtype == np.dtype(dtype)
        for i, want in enumerate(imgs):
            view, label = r[i]
            got = view.copy()  # a raw sample is a view of the mmap, which close() refuses to unmap
            del view
            assert got.dtype == want.dtype and label == 3 * i + 1
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(r.labels, 3 * np.arange(len(imgs)) + 1)
    finally:
        r.close()


def test_store_files_are_byte_equal(tmp_path):
    imgs = _samples(np.uint16, 1, seed=1)
    for name, pkg in PACKAGES.items():
        _write(pkg, str(tmp_path / f"{name}.mis"), imgs, jstore.CODEC_JLS)
    assert (tmp_path / "jax.mis").read_bytes() == (tmp_path / "port.mis").read_bytes()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    d = tmp_path_factory.mktemp("stores")
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, size=(16, 20, 1), dtype=np.uint8) for _ in range(37)]
    masks = [(img > 128).astype(np.uint8) for img in imgs]
    paths = {k: str(d / f"{k}.mis") for k in ("images", "masks")}
    _write(jstore, paths["images"], imgs, jstore.CODEC_RAW)
    _write(jstore, paths["masks"], masks, jstore.CODEC_RAW)
    return paths


def _epochs(loader, n=2):
    try:
        return [[tuple(np.copy(a) for a in batch) for batch in loader] for _ in range(n)]
    finally:
        loader.close()


def _assert_same_epochs(a, b):
    assert [len(e) for e in a] == [len(e) for e in b] and len(a[0]) > 0
    for ea, eb in zip(a, b):
        for ba, bb in zip(ea, eb):
            for xa, xb in zip(ba, bb):
                assert xa.dtype == xb.dtype
                np.testing.assert_array_equal(xa, xb)


@pytest.mark.parametrize("case", [
    dict(order="sequential", drop_last=False),
    dict(order="random"),
    dict(order="quasi_random", prefetch=0),
    dict(order="random", out_hw=(8, 12)),
    dict(order="random", precrop={"out_hw": (8, 8)}),
    dict(order="random", shard=(1, 2)),
])
def test_loader_matches_the_jax_loader(stores, case):
    kw = dict(batch_size=8, seed=3, use_native=False, **case)
    _assert_same_epochs(_epochs(jloader.Loader(stores["images"], **kw)),
                        _epochs(tloader.Loader(stores["images"], **kw)))


@pytest.mark.parametrize("order", ["random", "sequential"])
def test_paired_loader_matches_the_jax_loader(stores, order):
    kw = dict(batch_size=6, order=order, seed=4, use_native=False)
    _assert_same_epochs(_epochs(jloader.PairedLoader(stores["images"], stores["masks"], **kw)),
                        _epochs(tloader.PairedLoader(stores["images"], stores["masks"], **kw)))


@pytest.fixture(scope="module")
def decathlon_tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("decathlon")
    rng = np.random.default_rng(5)
    for sub in ("images", "masks"):
        os.makedirs(d / sub)
    for vol in range(4):
        for k in range(3):
            name = f"liver_{vol:03d}_{k}.png"
            img = rng.integers(0, 256, size=(30, 26), dtype=np.uint8)
            cv2.imwrite(str(d / "images" / name), img)
            cv2.imwrite(str(d / "masks" / name), (img > 150).astype(np.uint8) * 255)
    split = d / "split.json"
    split.write_text(json.dumps({"train": ["liver_000", "liver_002", "liver_003"], "val": ["liver_001"]}))
    return str(d / "images"), str(d / "masks"), str(split)


@pytest.mark.parametrize("split", [None, "train", "val"])
def test_decathlon_dataset_and_loader_match(decathlon_tree, split):
    images, masks, split_file = decathlon_tree
    dkw = dict(split_file=split_file, split=split) if split else {}
    jds, tds = jdec.DecathlonDataset(images, masks, **dkw), tdec.DecathlonDataset(images, masks, **dkw)
    assert jds.names == tds.names and len(tds) > 0
    for i in range(len(tds)):
        for a, b in zip(jds[i], tds[i]):
            np.testing.assert_array_equal(a, b)
    lkw = dict(batch_size=2, image_size=16, shuffle=split != "val", seed=1)
    _assert_same_epochs(_epochs(jdec.DecathlonLoader(jds, **lkw)), _epochs(tdec.DecathlonLoader(tds, **lkw)))


def test_extract_id_matches():
    from medical_image_segmentation_tpu.data.ingest.create_splits import extract_id

    for name in ("la_003_42.png", "liver_12_0.png", "a_b_c_7.png", "la_003.nii.gz", "x/y/spleen_9.nii"):
        assert tdec.extract_id(name) == extract_id(name)


@pytest.mark.parametrize("pixels,syntax", [
    ("u16", None),
    ("i16", None),
    ("u8_frames", None),
    ("u16", jdicom.JPEG_LS_LOSSLESS),
    ("u8", jdicom.JPEG_LS_LOSSLESS),
])
def test_read_dicom_matches(tmp_path, pixels, syntax):
    rng = np.random.default_rng(6)
    arr = {
        "u16": lambda: rng.integers(0, 4096, size=(18, 22)).astype(np.uint16),
        "i16": lambda: rng.integers(-1024, 2000, size=(18, 22)).astype(np.int16),
        "u8": lambda: rng.integers(0, 256, size=(18, 22)).astype(np.uint8),
        "u8_frames": lambda: rng.integers(0, 256, size=(3, 18, 22)).astype(np.uint8),
    }[pixels]()
    path = str(tmp_path / "x.dcm")
    jdicom.write_dicom(path, arr, transfer_syntax=syntax)
    want = jdicom.read_dicom(path).pixel_array
    got = tdicom.read_dicom(path).pixel_array
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)


def test_dicom_writer_refuses_jpeg2000(tmp_path, monkeypatch):
    """Lossy JPEG 2000 needs PIL and refuses by name without it; lossless
    JPEG 2000 now writes through the port's own encoder and needs nothing."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(tdicom.DicomError, match="JPEG 2000"):
        tdicom.write_dicom(str(tmp_path / "x.dcm"), np.zeros((4, 4), np.uint16),
                           transfer_syntax=tdicom.JPEG_2000)
    arr = np.arange(16, dtype=np.uint16).reshape(4, 4) * 97
    tdicom.write_dicom(str(tmp_path / "y.dcm"), arr, transfer_syntax=tdicom.JPEG_2000_LOSSLESS)
    np.testing.assert_array_equal(tdicom.read_dicom(str(tmp_path / "y.dcm")).pixel_array, arr)


def test_registry_lookups_match():
    regs = [pkg.Registry("thing") for pkg in (jreg, treg)]
    for r in regs:
        r.register("b")(2)
        r.register("a")(1)
    j, t = regs
    assert t.names() == j.names() == ["a", "b"] and t.get("a") == j.get("a") == 1
    assert ("a" in t) and ("z" not in t)
    for exc_src in (lambda r: r.get("z"), lambda r: r.register("a")(3)):
        msgs = []
        for r in regs:
            with pytest.raises(KeyError) as e:
                exc_src(r)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert set(tdm.DATAMODULES.names()) <= set(jdm.DATAMODULES.names())


def test_csv_metrics_logger_writes_equal_bytes(tmp_path):
    paths = []
    for name, pkg in (("jax", jlog), ("port", tlog)):
        for version in (None, None):  # the second picks version_1
            log = pkg.CSVMetricsLogger(str(tmp_path / name), name="run", version=version)
        log.log({"loss": 0.5}, step=1, epoch=0)
        log.log({"loss": 0.25, "lr": 0.1}, step=2, epoch=0)  # a new key rewrites the header
        log.log({"loss": 0.125, "lr": 0.05}, step=3)
        paths.append(log.path)
    assert paths[0].endswith(os.path.join("version_1", "metrics.csv"))
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_viz_grid_matches(tmp_path):
    rng = np.random.default_rng(7)
    images = rng.standard_normal((5, 12, 10, 1)).astype(np.float32)
    np.testing.assert_array_equal(tviz._normalize_to_uint8(images), jviz._normalize_to_uint8(images))
    u8 = rng.integers(0, 256, size=(5, 12, 10, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tviz._to_grid(u8, nrow=2), jviz._to_grid(u8, nrow=2))
    pred, true = rng.random((5, 12, 10, 1)) > 0.5, rng.random((5, 12, 10)) > 0.5
    jviz.save_combined_image_grid(images, pred, true, str(tmp_path / "j.png"), nrow=3)
    tviz.save_combined_image_grid(images, pred, true, str(tmp_path / "t.png"), nrow=3)
    want = cv2.cvtColor(cv2.imread(str(tmp_path / "j.png")), cv2.COLOR_BGR2RGB)  # OpenCV writes BGR
    np.testing.assert_array_equal(decode_png((tmp_path / "t.png").read_bytes()), want)


def test_port_imports_nothing_of_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import medical_image_segmentation_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "new = ['data.ingest.' + n for n in ('utils', 'create_subset', 'compute_stats', 'create_store',\n"
        "       'slice_decathlon', 'create_splits', 'create_seg_store', 'show_store', 'convert_datasets', 'tcia')]\n"
        "new += ['data.datasets', 'data.jpeg2000_encode', 'utils.plot_metrics', 'eval.parity', 'utils.resize',\n"
        "        'utils.jpeg', 'utils.imageio']\n"
        "missing = [m for m in new if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'medical_image_segmentation_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]


@pytest.mark.parametrize("task_cls", [SegmentationTask, BYOLTask])
def test_task_defaults_to_the_card_and_raises_without_one(monkeypatch, task_cls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        task_cls()
    assert task_cls(arch="resnet18", device="cpu").device.type == "cpu"
