"""The port's auxiliary tools against the JAX package's, on the CPU.

The twin of ``tests/test_tools.py`` for what this slice ports:
``data/datasets.py`` (with and without OpenCV), ``show_store``,
``utils/plot_metrics.py`` and ``utils/viz.py::save_image_grid``; the
``j2k_encode`` cases of ``tests/test_data_formats.py:1202-1260`` on the
port's ``data/jpeg2000_encode.py`` (its codestreams equal the JAX
encoder's byte for byte and decode through both packages and OpenJPEG);
``write_dicom`` with JPEG 2000 lossless read back by both packages; and
``convert_datasets --dataset radiology_1M`` byte-equal stores.
"""

import csv
import io
import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from medical_image_segmentation_tpu.data import datasets as j_datasets
from medical_image_segmentation_tpu.data import dicom as j_dicom
from medical_image_segmentation_tpu.data.ingest import convert_datasets as j_convert
from medical_image_segmentation_tpu.data.jpeg2000 import j2k_decode_py as j_j2k_decode
from medical_image_segmentation_tpu.data.jpeg2000_encode import j2k_encode as j_j2k_encode
from medical_image_segmentation_tpu.utils import plot_metrics as j_plot
from medical_image_segmentation_tpu_torch.data import datasets as t_datasets
from medical_image_segmentation_tpu_torch.data import dicom as t_dicom
from medical_image_segmentation_tpu_torch.data.ingest import convert_datasets as t_convert
from medical_image_segmentation_tpu_torch.data.ingest.show_store import main as show_store_main
from medical_image_segmentation_tpu_torch.data.jpeg2000 import j2k_decode_py as t_j2k_decode
from medical_image_segmentation_tpu_torch.data.jpeg2000_encode import j2k_encode as t_j2k_encode
from medical_image_segmentation_tpu_torch.data.store import CODEC_JPEG, CODEC_RAW, StoreWriter
from medical_image_segmentation_tpu_torch.utils import plot_metrics as t_plot
from medical_image_segmentation_tpu_torch.utils.viz import save_image_grid


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)


@pytest.fixture
def png_tree(tmp_path):
    rng = np.random.default_rng(2)
    d = tmp_path / "imgs" / "0"
    d.mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(d / f"u16_{i}.png"), rng.integers(0, 65536, size=(20 + i, 18)).astype(np.uint16))
    cv2.imwrite(str(d / "u8.png"), rng.integers(0, 256, size=(12, 16)).astype(np.uint8))
    cv2.imwrite(str(d / "rgb.png"), rng.integers(0, 256, size=(12, 16, 3)).astype(np.uint8))
    return tmp_path / "imgs"


@pytest.mark.parametrize("blocked", [False, True])
def test_radiology_dataset_matches(png_tree, monkeypatch, blocked):
    want = j_datasets.Radiology1MDataset(str(png_tree))
    items = [want[i] for i in range(len(want))]
    if blocked:
        monkeypatch.setitem(sys.modules, "cv2", None)
    got = t_datasets.Radiology1MDataset(str(png_tree))
    assert got.paths == want.paths and len(got) == 5
    for i, w in enumerate(items):
        g = got[i]
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_radiology_dataset_uint16_conversion(tmp_path, no_cv2):
    d = tmp_path / "imgs" / "0"
    d.mkdir(parents=True)
    cv2.imwrite(str(d / "a.png"), np.ones((8, 8), np.uint16) * 51400)  # 51400/256 = 200.78 → 200
    out = t_datasets.Radiology1MDataset(str(tmp_path / "imgs"))[0]
    assert out.shape == (8, 8, 1) and out.dtype == np.uint8 and int(out[0, 0, 0]) == 51400 // 256
    with pytest.raises(FileNotFoundError):
        t_datasets.Radiology1MDataset(str(tmp_path / "empty"))


@pytest.mark.parametrize("blocked", [False, True])
def test_chest_xray_csv_matches(tmp_path, monkeypatch, blocked):
    rng = np.random.default_rng(3)
    cv2.imwrite(str(tmp_path / "a.png"), rng.integers(0, 256, size=(8, 8)).astype(np.uint8))
    cv2.imwrite(str(tmp_path / "b.png"), rng.integers(0, 256, size=(9, 7, 3)).astype(np.uint8))
    csv_path = str(tmp_path / "m.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["Image Index", "Finding Labels"])
        w.writeheader()
        w.writerow({"Image Index": "a.png", "Finding Labels": "Atelectasis|Effusion"})
        w.writerow({"Image Index": "b.png", "Finding Labels": "No Finding"})
    want = j_datasets.ChestXRayDataset(str(tmp_path), csv_path)
    items = [want[i] for i in range(2)]
    if blocked:
        monkeypatch.setitem(sys.modules, "cv2", None)
    got = t_datasets.ChestXRayDataset(str(tmp_path), csv_path)
    assert got.num_classes == want.num_classes == 2 and got.label_index == want.label_index
    for i in range(2):
        img, label = got[i]
        assert label == items[i][1]
        np.testing.assert_array_equal(img, items[i][0])


@pytest.mark.parametrize("blocked", [False, True])
def test_convert_radiology_stores_equal(png_tree, tmp_path, monkeypatch, blocked):
    args = ["--dataset", "radiology_1M", "--data_root", str(png_tree), "--max_resolution", "16",
            "--num_workers", "1"]
    assert j_convert.main(args + ["--output_dir", str(tmp_path / "jax")]) == 0
    if blocked:
        monkeypatch.setitem(sys.modules, "cv2", None)
    assert t_convert.main(args + ["--output_dir", str(tmp_path / "torch")]) == 0
    name = "radiology_1M_16_train.mis"
    assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_convert_imagefolder_without_opencv(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    for c in ("cat", "dog"):
        (tmp_path / "root" / c).mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(tmp_path / "root" / c / f"{i}.png"), rng.integers(0, 256, size=(10, 12, 3)).astype(np.uint8))
    cv2.imwrite(str(tmp_path / "root" / "dog" / "g.png"), rng.integers(0, 256, size=(10, 12)).astype(np.uint8))
    args = ["--dataset", "imagefolder", "--data_root", str(tmp_path / "root"), "--raw", "--num_workers", "1"]
    assert j_convert.main(args + ["--output_dir", str(tmp_path / "jax")]) == 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert t_convert.main(args + ["--output_dir", str(tmp_path / "torch")]) == 0
    name = "imagefolder_0_train.mis"
    assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("blocked", [False, True])
def test_show_store_grid(tmp_path, monkeypatch, blocked):
    store = str(tmp_path / "s.mis")
    rng = np.random.default_rng(1)
    with StoreWriter(store, channels=1) as w:
        for i in range(4):
            w.add(rng.integers(0, 255, size=(16, 16 - i, 1)).astype(np.uint8), codec=CODEC_JPEG if i % 2 else CODEC_RAW)
    if blocked:
        monkeypatch.setitem(sys.modules, "cv2", None)
    out = str(tmp_path / "g.png")
    assert show_store_main(["--store", store, "--num_images", "4", "--output", out]) == 0
    img = cv2.imread(out, cv2.IMREAD_UNCHANGED)
    assert img is not None and img.shape == (2 + 18, 2 + 4 * 18)


def test_save_image_grid_matches_reference(tmp_path, monkeypatch):
    from medical_image_segmentation_tpu.utils.viz import save_image_grid as j_grid

    batch = np.random.default_rng(0).integers(0, 255, size=(9, 16, 16, 1)).astype(np.uint8)
    j_grid(batch, str(tmp_path / "j.png"), nrow=3)
    monkeypatch.setitem(sys.modules, "cv2", None)
    save_image_grid(batch, str(tmp_path / "t.png"), nrow=3)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED))


def test_plot_metrics_matches(tmp_path, capsys):
    paths = []
    for v in range(2):
        p = str(tmp_path / f"version_{v}" / "metrics.csv")
        os.makedirs(os.path.dirname(p))
        with open(p, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["loss", "step", "val/acc@1"])
            w.writeheader()
            for i in range(20):
                w.writerow({"loss": 1.0 / (i + 1 + v), "step": i + 20 * v, "val/acc@1": "" if i % 3 else i})
        paths.append(p)
    for metric in ("loss", "val/acc@1", "missing"):
        got, want = t_plot.load_metric(paths, metric), j_plot.load_metric(paths, metric)
        assert got == want
        for ylim in (None, (0.0, 0.5)):
            assert t_plot.ascii_plot(*got, ylim=ylim, title=metric) == j_plot.ascii_plot(*want, ylim=ylim, title=metric)
    glob_arg = str(tmp_path / "version_*" / "metrics.csv")
    assert t_plot.main(["--log_glob", glob_arg, "--metric", "loss", "--ymin", "0", "--ymax", "1"]) == 0
    t_out = capsys.readouterr().out
    assert j_plot.main(["--log_glob", glob_arg, "--metric", "loss", "--ymin", "0", "--ymax", "1"]) == 0
    assert t_out == capsys.readouterr().out and "*" in t_out
    assert t_plot.main(["--log_glob", str(tmp_path / "nothing*.csv")]) == 1


# ---------------------------------------------------------------------------
# JPEG 2000
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype,levels", [
    ((1, 1), np.uint8, None), ((5, 7), np.uint8, 0), ((64, 80), np.uint8, None), ((33, 65), np.uint16, 3),
    ((17, 17), np.uint16, 1), ((128, 96), np.uint8, 5), ((40, 56), np.uint16, None), ((37, 41), np.int16, None),
    ((32, 32, 3), np.uint8, None)])
def test_j2k_encode_matches_and_roundtrips(shape, dtype, levels):
    rng = np.random.default_rng(30)
    if dtype == np.int16:
        arr = rng.integers(-2048, 2048, size=shape).astype(np.int16)
    else:
        arr = rng.integers(0, np.iinfo(dtype).max + 1, size=shape, dtype=dtype)
    blob = t_j2k_encode(arr, levels=levels)
    assert blob == j_j2k_encode(arr, levels=levels)
    for decode in (t_j2k_decode, j_j2k_decode):
        out = np.asarray(decode(blob))
        assert out.dtype == arr.dtype
        np.testing.assert_array_equal(out, arr)


def test_openjpeg_decodes_port_streams():
    rng = np.random.default_rng(34)
    for arr in (rng.integers(0, 256, size=(64, 80), dtype=np.uint8),
                rng.integers(0, 65536, size=(33, 47)).astype(np.uint16),
                rng.integers(0, 256, size=(24, 24, 3), dtype=np.uint8)):
        with Image.open(io.BytesIO(t_j2k_encode(arr))) as im:
            got = np.asarray(im)
        np.testing.assert_array_equal(got.astype(arr.dtype).reshape(arr.shape), arr)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_write_dicom_jpeg2000_read_by_both(tmp_path, dtype, no_cv2):
    rng = np.random.default_rng(9)
    arr = rng.integers(0, 4096 if dtype == np.uint16 else 256, size=(33, 29)).astype(dtype)
    path = str(tmp_path / "x.dcm")
    t_dicom.write_dicom(path, arr, transfer_syntax=t_dicom.JPEG_2000_LOSSLESS)
    j_path = str(tmp_path / "j.dcm")
    j_dicom.write_dicom(j_path, arr, transfer_syntax=j_dicom.JPEG_2000_LOSSLESS)
    assert open(path, "rb").read() == open(j_path, "rb").read()
    for read in (t_dicom.read_dicom, j_dicom.read_dicom):
        got = read(path).pixel_array
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)


_SCRIPTS = ["create-subset", "create-store", "slice-decathlon", "create-splits", "compute-stats", "show-store",
            "convert-datasets", "plot-metrics", "tcia", "parity"]


@pytest.mark.parametrize("name", _SCRIPTS)
def test_new_scripts_answer_help(name, capsys):
    """Each of the slice's ten ``mis-*-torch`` scripts is in pyproject.toml
    beside its JAX twin and answers ``--help``."""
    import importlib
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml")) as f:
        text = f.read()
    twin = re.search(rf'^mis-{name} = "medical_image_segmentation_tpu\.([\w.]+):main"$', text, re.M)
    port = re.search(rf'^mis-{name}-torch = "medical_image_segmentation_tpu_torch\.([\w.]+):main"$', text, re.M)
    assert twin and port and twin.group(1) == port.group(1)
    main = importlib.import_module(f"medical_image_segmentation_tpu_torch.{port.group(1)}").main
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0 and "usage" in capsys.readouterr().out
