"""The port's data-curation layer against the JAX package's, on the CPU.

The twin of ``tests/test_ingest.py``: the same synthetic DICOM, NIfTI and
PNG trees (written here from a seed) go through both packages' CLIs.

- ``process_files`` (the port starts its workers with ``spawn``): per-path
  results, the error contract, a 10k-path stress;
- ``dicom_sizes`` / ``dicom_hashes`` / ``raster_sizes`` maps equal;
  ``write_subset`` maps equal (paths relative to each output) and the
  curated 16-bit PNGs pixel-equal; retry, ``--write_to_null``, ordering;
- stores (PNG tree → JPEG at 224, raw, 16-bit JPEG-LS; DICOM tree through
  the BICUBIC route; a worker pool) byte-equal;
- stats JSON equal to 1e-9 relative (store with ``--center_crop``, PNG tree);
- Decathlon slices pixel-equal, splits JSON equal exactly, seg stores
  byte-equal;
- the TCIA manifests of ``data/tcia_manifests/`` parse the same; the fetch
  runs on a patched ``urllib.request`` and never reaches the network;
- ``create_store``, ``create_seg_store``, ``slice_decathlon`` and
  ``compute_stats`` run again with ``cv2`` and ``PIL`` blocked
  (``sys.modules[...] = None``): the same stores byte for byte, the same
  slices to the pixel, the same stats.
"""

import glob
import io
import json
import os
import shutil
import sys
import urllib.error
import zipfile

import cv2
import numpy as np
import pytest

from medical_image_segmentation_tpu.data.dicom import write_dicom
from medical_image_segmentation_tpu.data.ingest import compute_stats as j_stats
from medical_image_segmentation_tpu.data.ingest import create_seg_store as j_seg
from medical_image_segmentation_tpu.data.ingest import create_splits as j_splits
from medical_image_segmentation_tpu.data.ingest import create_store as j_store
from medical_image_segmentation_tpu.data.ingest import create_subset as j_subset
from medical_image_segmentation_tpu.data.ingest import slice_decathlon as j_slice
from medical_image_segmentation_tpu.data.ingest import tcia as j_tcia
from medical_image_segmentation_tpu.data.nifti import write_nifti
from medical_image_segmentation_tpu_torch.data import volumes as t_volumes
from medical_image_segmentation_tpu_torch.data.ingest import compute_stats as t_stats
from medical_image_segmentation_tpu_torch.data.ingest import create_seg_store as t_seg
from medical_image_segmentation_tpu_torch.data.ingest import create_splits as t_splits
from medical_image_segmentation_tpu_torch.data.ingest import create_store as t_store
from medical_image_segmentation_tpu_torch.data.ingest import create_subset as t_subset
from medical_image_segmentation_tpu_torch.data.ingest import slice_decathlon as t_slice
from medical_image_segmentation_tpu_torch.data.ingest import tcia as t_tcia
from medical_image_segmentation_tpu_torch.data.ingest import utils as t_utils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """med_datasets/<ds>/*.dcm (sizes in and out of range, pixel
    duplicates), a 16-bit PNG tree, Decathlon NIfTI pairs."""
    root = tmp_path_factory.mktemp("ingest")
    rng = np.random.default_rng(11)
    for ds, n in (("pancreasct", 7), ("dukebreastcancer", 3)):
        d = root / "med_datasets" / ds
        d.mkdir(parents=True)
        for i in range(n):
            size = (300, 260) if i % 2 else (257, 310)
            y, x = np.mgrid[: size[0], : size[1]]
            arr = ((np.sin(x / (9.0 + i)) + np.cos(y / 7.0) + 2) * 1000 + rng.integers(0, 50, size)).astype(np.uint16)
            write_dicom(str(d / f"img{i}.dcm"), arr)
    d = root / "med_datasets" / "pancreasct"
    shutil.copy(d / "img0.dcm", d / "dup.dcm")  # same pixels: deduped
    write_dicom(str(d / "small.dcm"), np.zeros((100, 100), np.uint16))
    write_dicom(str(d / "big.dcm"), np.zeros((900, 900), np.uint16))
    (d / "broken.dcm").write_bytes(b"not a dicom")
    val = root / "val_pngs" / "a"
    val.mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(val / f"v{i}.png"), rng.integers(0, 65536, size=(96 + 8 * i, 90)).astype(np.uint16))
    cv2.imwrite(str(root / "val_pngs" / "c.png"), rng.integers(0, 256, size=(40, 50, 3)).astype(np.uint8))
    for sub in ("imagesTr", "labelsTr"):
        (root / "Task99" / sub).mkdir(parents=True)
    for v in range(5):
        vol = rng.normal(100, 40, size=(80, 72, 4)).astype(np.float32)
        seg = np.zeros((80, 72, 4), np.uint8)
        seg[20 + v:50, 15:40 + v, 1:] = 1 + v % 2
        write_nifti(str(root / "Task99" / "imagesTr" / f"la_{v:03d}.nii.gz"), vol)
        write_nifti(str(root / "Task99" / "labelsTr" / f"la_{v:03d}.nii.gz"), seg)
    return root


def _json(path):
    with open(path) as f:
        return json.load(f)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _scan(mod, root, out, procs):
    dicoms = str(root / "med_datasets")
    for cmd in ("dicom_sizes", "dicom_hashes"):
        assert mod.main([cmd, dicoms, "--output", str(out / f"{cmd}.json"), "--num_processes", str(procs)]) == 0
    assert mod.main(["raster_sizes", str(root / "val_pngs"), "--output", str(out / "raster.json"),
                     "--num_processes", "1"]) == 0


@pytest.fixture(scope="module")
def curated(trees, tmp_path_factory):
    """Both packages' scans and curated subsets (port: two spawned workers).
    Both curate from the JAX scan's maps: with several workers the
    reference's maps follow the workers' completion order, which decides
    which of two duplicates survives the dedup."""
    outs = {}
    for name, mod, procs in (("jax", j_subset, 1), ("torch", t_subset, 2)):
        out = tmp_path_factory.mktemp(f"curated_{name}")
        _scan(mod, trees, out, procs)
        scans = outs.get("jax", out)
        assert mod.main(["write_subset", "--dimensions_map", str(scans / "dicom_sizes.json"),
                         "--hashes_map", str(scans / "dicom_hashes.json"), "--output_dir", str(out / "subset"),
                         "--size", "6", "--num_subfolders", "3", "--num_processes", str(procs),
                         "--mapping_output", str(out / "map.json")]) == 0
        outs[name] = out
    return outs


# ---------------------------------------------------------------------------
# process_files
# ---------------------------------------------------------------------------

class TestProcessFiles:
    def test_single_and_multi_process(self):
        paths = [f"d{i}/f{i}" for i in range(20)]
        for procs in (1, 2):
            out = t_utils.process_files(paths, os.path.basename, procs, quiet=True)
            assert out == {p: os.path.basename(p) for p in paths}

    def test_invalid_process_count_raises(self):
        with pytest.raises(ValueError):
            t_utils.process_files(["a"], os.path.basename, 0)

    def test_worker_error_propagates(self):
        with pytest.raises(ValueError):
            t_utils.process_files(["1", "2", "x", "4"], int, 2, quiet=True)

    def test_10k_paths_two_workers(self):
        paths = [str(i) for i in range(10_000)]
        out = t_utils.process_files(paths, int, 2, quiet=True)
        assert len(out) == 10_000 and out["9999"] == 9999

    def test_get_file_paths_and_counts_match(self, trees):
        from medical_image_segmentation_tpu.data.ingest import utils as j_utils

        for exts in ([".dcm"], [".png"], None):
            assert t_utils.get_file_paths([str(trees)], exts) == j_utils.get_file_paths([str(trees)], exts)
        assert t_utils.get_file_type_counts([str(trees)]) == j_utils.get_file_type_counts([str(trees)])


# ---------------------------------------------------------------------------
# scans and the curated subset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dicom_sizes.json", "dicom_hashes.json", "raster.json"])
def test_scan_maps_equal(curated, name):
    got, want = _json(curated["torch"] / name), _json(curated["jax"] / name)
    assert got == want
    assert len(want) >= 5
    assert list(got) == sorted(got, key=list(want).index)  # the port keeps the scan's order


def test_write_subset_maps_and_pixels_equal(curated):
    jmap, tmap = _json(curated["jax"] / "map.json"), _json(curated["torch"] / "map.json")
    rel = {k: os.path.relpath(v, curated["jax"]) for k, v in jmap.items()}
    assert {k: os.path.relpath(v, curated["torch"]) for k, v in tmap.items()} == rel
    assert len(tmap) == 6
    for k in jmap:
        want = cv2.imread(jmap[k], cv2.IMREAD_UNCHANGED)
        got = cv2.imread(tmap[k], cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint16 and got.min() == 0 and got.max() == 65535
        np.testing.assert_array_equal(got, want)


def test_write_subset_without_opencv_pixels_equal(curated, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = curated["torch"]
    assert t_subset.main(["raster_sizes", str(out / "subset"), "--output", str(tmp_path / "r.json"),
                          "--num_processes", "1"]) == 0
    scans = curated["jax"]
    mapping = t_subset.write_subset(_json(scans / "dicom_sizes.json"), _json(scans / "dicom_hashes.json"),
                                    str(tmp_path / "subset"), size=6, num_subfolders=3, seed=2)
    tmap = _json(out / "map.json")
    assert set(mapping) == set(tmap)
    sizes = _json(tmp_path / "r.json")
    for k, path in mapping.items():
        want = cv2.imread(tmap[k], cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), want)
        assert sizes[tmap[k]] == list(want.shape)


def test_retry_tops_up_and_write_to_null(trees, tmp_path):
    paths = t_utils.get_file_paths([str(trees / "med_datasets")], [".dcm"])
    dims = t_subset.get_dicom_image_dimensions(paths, 1)
    hashes = t_subset.get_dicom_image_hashes(paths, 1)
    bad = sorted(t_subset.pick_possible_images(dims, hashes))[:2]
    work = tmp_path / "copy"
    shutil.copytree(trees / "med_datasets", work / "med_datasets")
    moved = {str(p).replace(str(trees), str(work)) for p in bad}
    for p in moved:
        open(p, "wb").write(b"garbage")
    dims2 = {k.replace(str(trees), str(work)): v for k, v in dims.items()}
    hashes2 = {k.replace(str(trees), str(work)): v for k, v in hashes.items()}
    mapping = t_subset.write_subset(dims2, hashes2, str(tmp_path / "subset"), size=4, num_subfolders=2, seed=0)
    assert len(mapping) == 4 and not (moved & set(mapping))
    null = t_subset.write_subset(dims, hashes, str(tmp_path / "x"), size=3, write_to_null=True)
    assert len(null) == 3 and not (tmp_path / "x").exists()
    ordered = t_subset.order_candidates(sorted(dims), seed=1)
    assert ordered == j_subset.order_candidates(sorted(dims), seed=1)
    assert [("duke" in p) for p in ordered] == sorted("duke" in p for p in ordered)


# ---------------------------------------------------------------------------
# stores and stats
# ---------------------------------------------------------------------------

_STORE_ARGS = {
    "jpeg224": ["--max_resolution", "224"],
    "raw224": ["--max_resolution", "224", "--raw"],
    "jls16": ["--max_resolution", "200", "--bit_depth", "16"],
}


def _stores(mod, png_dir, dicom_dir, out, workers):
    os.makedirs(out, exist_ok=True)
    for tag, extra in _STORE_ARGS.items():
        assert mod.main(["--png_dir", png_dir, "--output", os.path.join(out, f"{tag}.mis"),
                         "--num_workers", "1", *extra]) == 0
    assert mod.main(["--dicom_dir", dicom_dir, "--output", os.path.join(out, "dicom.mis"),
                     "--max_resolution", "224", "--num_workers", str(workers)]) == 0
    assert mod.main(["--dicom_dir", dicom_dir, "--output", os.path.join(out, "dicom16.mis"),
                     "--max_resolution", "128", "--bit_depth", "16", "--raw", "--num_workers", "1"]) == 0


def _stats(mod, out):
    for tag in ("jpeg224", "dicom"):
        assert mod.main(["--store", os.path.join(out, f"{tag}.mis"), "--center_crop", "224",
                         "--output", os.path.join(out, f"{tag}_stats.json")]) == 0


@pytest.fixture(scope="module")
def stores(curated, trees, tmp_path_factory):
    out = tmp_path_factory.mktemp("stores")
    png = str(curated["jax"] / "subset")  # one input for both packages
    dicoms = str(trees / "med_datasets")
    _stores(j_store, png, dicoms, str(out / "jax"), 1)
    _stores(t_store, png, dicoms, str(out / "torch"), 2)
    for name, mod in (("jax", j_stats), ("torch", t_stats)):
        _stats(mod, str(out / name))
        assert mod.main(["--image_dir", str(trees / "val_pngs"), "--scale", str(1 / 255),
                         "--output", str(out / name / "png_stats.json")]) == 0
    return out


@pytest.mark.parametrize("tag", ["jpeg224", "raw224", "jls16", "dicom", "dicom16"])
def test_stores_byte_equal(stores, tag):
    assert _read(stores / "torch" / f"{tag}.mis") == _read(stores / "jax" / f"{tag}.mis")


@pytest.mark.parametrize("name", ["jpeg224_stats.json", "dicom_stats.json", "png_stats.json"])
def test_stats_equal(stores, name):
    got, want = _json(stores / "torch" / name), _json(stores / "jax" / name)
    assert got["pixels"] == want["pixels"]
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-9)
    np.testing.assert_allclose(got["std"], want["std"], rtol=1e-9)


def test_stores_and_stats_again_without_opencv_or_pil(stores, curated, trees, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = str(tmp_path / "blocked")
    _stores(t_store, str(curated["jax"] / "subset"), str(trees / "med_datasets"), out, 1)
    _stats(t_stats, out)
    assert t_stats.main(["--image_dir", str(trees / "val_pngs"), "--scale", str(1 / 255),
                         "--output", os.path.join(out, "png_stats.json")]) == 0
    for tag in _STORE_ARGS.keys() | {"dicom", "dicom16"}:
        assert _read(os.path.join(out, f"{tag}.mis")) == _read(stores / "jax" / f"{tag}.mis"), tag
    for name in ("jpeg224_stats.json", "dicom_stats.json", "png_stats.json"):
        assert _json(os.path.join(out, name)) == _json(stores / "torch" / name)


# ---------------------------------------------------------------------------
# Decathlon: slices, splits, seg stores
# ---------------------------------------------------------------------------

def _decathlon(mod_slice, mod_splits, mod_seg, trees, out, procs):
    task = trees / "Task99"
    images, masks = os.path.join(out, "images"), os.path.join(out, "masks")
    assert mod_slice.main(["--images_dir", str(task / "imagesTr"), "--labels_dir", str(task / "labelsTr"),
                           "--images_out", images, "--masks_out", masks, "--num_processes", str(procs)]) == 0
    assert mod_splits.main(["--images_dir", images, "--output_dir", os.path.join(out, "splits"), "--seed", "3"]) == 0
    for size in (64, 96):
        assert mod_seg.main(["--images_dir", images, "--masks_dir", masks,
                             "--output_prefix", os.path.join(out, f"seg{size}", "liver"),
                             "--split_file", os.path.join(out, "splits", "split_100_percent_train.json"),
                             "--image_size", str(size)]) == 0


@pytest.fixture(scope="module")
def decathlon(trees, tmp_path_factory):
    out = tmp_path_factory.mktemp("decathlon")
    _decathlon(j_slice, j_splits, j_seg, trees, str(out / "jax"), 1)
    _decathlon(t_slice, t_splits, t_seg, trees, str(out / "torch"), 2)
    return out


def _files(root, pattern):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, pattern), recursive=True))


def test_slices_pixel_equal(decathlon):
    names = _files(decathlon / "jax", "*/*.png")
    assert names == _files(decathlon / "torch", "*/*.png") and len(names) == 40
    for n in names:
        want = cv2.imread(str(decathlon / "jax" / n), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(decathlon / "torch" / n), cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_splits_equal(decathlon):
    names = _files(decathlon / "jax", "splits/*.json")
    assert names == _files(decathlon / "torch", "splits/*.json") and len(names) == 5
    for n in names:
        assert _json(decathlon / "torch" / n) == _json(decathlon / "jax" / n)


def test_seg_stores_byte_equal(decathlon):
    names = _files(decathlon / "jax", "seg*/*")
    assert names == _files(decathlon / "torch", "seg*/*") and len(names) == 14
    for n in names:
        assert _read(decathlon / "torch" / n) == _read(decathlon / "jax" / n), n


def test_decathlon_again_without_opencv_or_pil(decathlon, trees, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    _decathlon(t_slice, t_splits, t_seg, trees, str(tmp_path), 1)
    for n in _files(decathlon / "torch", "*/*.png"):
        want = cv2.imread(str(decathlon / "torch" / n), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / n), cv2.IMREAD_UNCHANGED), want)
    for n in _files(decathlon / "torch", "seg*/*") + _files(decathlon / "torch", "splits/*.json"):
        assert _read(tmp_path / n) == _read(decathlon / "torch" / n), n


def test_volume_pairing_is_the_slicers(trees):
    images, labels = str(trees / "Task99" / "imagesTr"), str(trees / "Task99" / "labelsTr")
    assert t_volumes.pair_scans_and_masks is t_slice.pair_scans_and_masks
    assert t_slice.pair_scans_and_masks(images, labels) == j_slice.pair_scans_and_masks(images, labels)
    assert len(t_slice.pair_scans_and_masks(images, labels)) == 5


def test_splits_functions_match():
    ids = [f"v_{i:03d}" for i in range(37)]
    for seed in (0, 5):
        sp = t_splits.create_split(ids, seed=seed)
        assert sp == j_splits.create_split(ids, seed=seed)
        for pct in (10, 25, 50, 100):
            assert (t_splits.create_split_by_percent(sp, pct, seed=seed)
                    == j_splits.create_split_by_percent(sp, pct, seed=seed))
    for name in ("la_003_42.png", "liver_117_0.png", "la_003.nii.gz", "la_003.nii"):
        assert t_splits.extract_id(name) == j_splits.extract_id(name)


def test_streaming_moments_match():
    rng = np.random.default_rng(1)
    batches = [rng.random((4, 8, 8, 3)) * 255 for _ in range(5)]
    got = t_stats.compute_mean_and_std(batches, channels=3)
    want = j_stats.compute_mean_and_std(batches, channels=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# TCIA
# ---------------------------------------------------------------------------

_MANIFESTS = sorted(glob.glob(os.path.join(ROOT, "data", "tcia_manifests", "*.tcia")))


@pytest.mark.parametrize("path", _MANIFESTS, ids=[os.path.basename(p) for p in _MANIFESTS])
def test_manifest_parses_the_same(path):
    got, want = t_tcia.parse_manifest(path), j_tcia.parse_manifest(path)
    assert got.__dict__ == want.__dict__
    assert got.series_uids


class _Response(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_fetch_on_a_patched_urllib(tmp_path, monkeypatch, capsys):
    import urllib.request

    blob = io.BytesIO()
    with zipfile.ZipFile(blob, "w") as zf:
        zf.writestr("a/1.dcm", b"x")
        zf.writestr("a/2.dcm", b"y")
        zf.writestr("a/readme.txt", b"z")
    seen = []

    def fake_urlopen(url, timeout):
        seen.append(url)
        if url.endswith("=bad"):
            raise urllib.error.URLError("no route")
        return _Response(blob.getvalue())

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    assert t_tcia.download_series("1.2.3", str(tmp_path / "s")) == {"files": 2}
    assert "error" in t_tcia.download_series("bad", str(tmp_path / "t"))
    manifest = tmp_path / "m.tcia"
    manifest.write_text("manifestVersion=3.0\nListOfSeriesToDownload=\n1.2.3\n4.5.6\n")
    assert t_tcia.main([str(manifest), "--output_dir", str(tmp_path / "all")]) == 0
    assert sorted(os.listdir(tmp_path / "all")) == ["1.2.3", "4.5.6"]
    assert t_tcia.main([str(manifest), "--limit", "1"]) == 0
    assert capsys.readouterr().out.split() == ["1.2.3"]
    assert all(u.startswith(t_tcia.TCIA_REST_BASE) for u in seen) and len(seen) == 4


def test_fetch_without_urllib_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "urllib.request", None)
    with pytest.raises(ImportError):
        t_tcia.download_series("1.2.3", str(tmp_path / "s"))
