"""The port's NIfTI codec, volume datasets and loader against the JAX
package's, on the CPU.

Both sides are host code in numpy, so every comparison is exact
(``np.array_equal``, dtypes included): each package reads the files the
other wrote, and the datasets and loaders of both are walked over the same
synthetic Decathlon directory, written from a seed.
"""

import json
import os

import numpy as np
import pytest

from medical_image_segmentation_tpu.data import nifti as jnifti
from medical_image_segmentation_tpu.data import volumes as jvol
from medical_image_segmentation_tpu.data.ingest.slice_decathlon import pair_scans_and_masks as jax_pairs
from medical_image_segmentation_tpu_torch.data import nifti as tnifti
from medical_image_segmentation_tpu_torch.data import volumes as tvol


def _same(a, b) -> bool:
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32, np.uint16])
def test_each_package_reads_what_the_other_wrote(tmp_path, ext, dtype):
    data = np.random.default_rng(0).integers(0, 200, (5, 6, 7)).astype(dtype)
    for writer, reader in ((tnifti, jnifti), (jnifti, tnifti)):
        path = str(tmp_path / f"{writer.__name__}{ext}")
        writer.write_nifti(path, data)
        got = reader.read_nifti(path)
        assert _same(np.asarray(got.data), data) and got.shape == data.shape
        assert _same(got.get_fdata(), data.astype(np.float64))
    with open(tmp_path / f"{tnifti.__name__}{ext}", "rb") as a, open(tmp_path / f"{jnifti.__name__}{ext}", "rb") as b:
        if ext == ".nii":  # a gzip stream carries its time of writing
            assert a.read() == b.read()


def test_scl_slope_and_inter_and_a_4d_volume(tmp_path):
    data = np.random.default_rng(1).integers(-50, 50, (4, 5, 6, 2)).astype(np.int16)
    path = str(tmp_path / "scaled.nii.gz")
    tnifti.write_nifti(path, data, scl_slope=0.5, scl_inter=-3.0)
    ours, theirs = tnifti.read_nifti(path), jnifti.read_nifti(path)
    assert (ours.scl_slope, ours.scl_inter, ours.pixdim) == (theirs.scl_slope, theirs.scl_inter, theirs.pixdim)
    assert _same(ours.get_fdata(), theirs.get_fdata())
    assert _same(ours.get_fdata(), data * 0.5 - 3.0)
    zero = str(tmp_path / "zero_slope.nii")
    tnifti.write_nifti(zero, data, scl_slope=0.0)  # a slope of 0 means "no scaling"
    assert _same(tnifti.read_nifti(zero).get_fdata(), data.astype(np.float64))


def test_bad_files_raise_as_in_the_reference(tmp_path):
    short = tmp_path / "short.nii"
    short.write_bytes(b"\0" * 100)
    bad = tmp_path / "bad.nii"
    bad.write_bytes(b"\1" * 400)
    for mod in (tnifti, jnifti):
        with pytest.raises(ValueError, match="too small"):
            mod.read_nifti(str(short))
        with pytest.raises(ValueError, match="not little-endian"):
            mod.read_nifti(str(bad))
        with pytest.raises(ValueError, match="unsupported dtype"):
            mod.write_nifti(str(tmp_path / "c.nii"), np.zeros((2, 2, 2), np.complex64))


@pytest.mark.parametrize("shape,target", [((5, 9, 12), (8, 8, 8)), ((10, 4, 7, 1), (6, 6, 6)), ((6, 6, 6), (6, 6, 6))])
def test_center_fit_pads_and_crops_like_the_reference(shape, target):
    vol = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got, want = tvol.center_fit(vol, target), jvol.center_fit(vol, target)
    assert got.shape[:3] == target and _same(got, want)


@pytest.fixture(scope="module")
def decathlon(tmp_path_factory):
    """A Decathlon-style directory: 7 ragged int16 volumes with masks (one
    4-D, one flat, one mask without an image, a hidden file) and a split."""
    root = tmp_path_factory.mktemp("decathlon")
    images, labels = root / "imagesTr", root / "labelsTr"
    images.mkdir()
    labels.mkdir()
    rng = np.random.default_rng(3)
    for i in range(7):
        shape = tuple(int(s) for s in rng.integers(7, 14, 3))
        vol = rng.integers(-1000, 1000, shape).astype(np.int16)
        if i == 5:
            vol[:] = 7  # flat: min == max
        seg = (rng.random(shape) < 0.3).astype(np.uint8) * (1 + i % 2)
        ext = ".nii" if i % 3 == 0 else ".nii.gz"
        tnifti.write_nifti(str(images / f"liver_{i}{ext}"),
                           np.stack([vol, vol // 2], axis=-1) if i == 2 else vol)
        tnifti.write_nifti(str(labels / f"liver_{i}{ext}"), seg)
    tnifti.write_nifti(str(labels / "liver_99.nii.gz"), np.zeros((3, 3, 3), np.uint8))
    (images / "._liver_0.nii.gz").write_bytes(b"junk")
    split = root / "split.json"
    split.write_text(json.dumps({"train": [f"liver_{i}" for i in (0, 1, 2, 3, 5)], "val": ["liver_4", "liver_6"],
                                 "test": []}))
    return str(images), str(labels), str(split)


def test_pairing_matches_the_slicer(decathlon):
    images, labels, _ = decathlon
    assert tvol.pair_scans_and_masks(images, labels) == jax_pairs(images, labels)
    assert len(tvol.pair_scans_and_masks(images, labels)) == 7


@pytest.mark.parametrize("split,count", [(None, 7), ("train", 5), ("val", 2)])
def test_paired_dataset_items_and_raw_are_the_references(decathlon, split, count):
    images, labels, split_file = decathlon
    kw = dict(target_shape=(8, 10, 12), split_file=split_file if split else None, split=split or "train")
    ours, theirs = tvol.DecathlonVolumeDataset(images, labels, **kw), jvol.DecathlonVolumeDataset(images, labels, **kw)
    assert len(ours) == len(theirs) == count and ours.pairs == theirs.pairs
    for i in range(count):
        for got, want in zip(ours[i] + ours.raw(i), theirs[i] + theirs.raw(i)):
            assert _same(got, want)
        img, msk = ours[i]
        assert img.shape == msk.shape == (8, 10, 12, 1) and set(np.unique(msk)) <= {0.0, 1.0}
        assert 0.0 <= img.min() and img.max() <= 1.0


def test_dataset_cache_and_errors(decathlon, tmp_path):
    images, labels, split_file = decathlon
    cached = tvol.DecathlonVolumeDataset(images, labels, target_shape=(8, 8, 8), cache=True)
    assert cached[1][0] is cached[1][0]  # the second read is the cached pair
    plain = tvol.DecathlonVolumeDataset(images, labels, target_shape=(8, 8, 8))
    assert plain[1][0] is not plain[1][0] and _same(plain[1][0], cached[1][0])
    with pytest.raises(ValueError, match="no volume pairs"):
        tvol.DecathlonVolumeDataset(images, str(tmp_path), split_file=None)
    with pytest.raises(ValueError, match="no volume pairs"):
        tvol.DecathlonVolumeDataset(images, labels, split_file=split_file, split="test")
    bad = tmp_path / "bad"
    (bad / "i").mkdir(parents=True)
    (bad / "l").mkdir()
    tnifti.write_nifti(str(bad / "i" / "a.nii"), np.zeros((3, 4, 5), np.int16))
    tnifti.write_nifti(str(bad / "l" / "a.nii"), np.zeros((3, 4, 6), np.uint8))
    with pytest.raises(ValueError, match="shape mismatch"):
        tvol.DecathlonVolumeDataset(str(bad / "i"), str(bad / "l"))[0]


def test_unlabeled_dataset_is_the_references(decathlon, tmp_path):
    images, _, _ = decathlon
    ours = tvol.UnlabeledVolumeDataset(images, target_shape=(8, 10, 12), cache=True)
    theirs = jvol.UnlabeledVolumeDataset(images, target_shape=(8, 10, 12))
    assert len(ours) == len(theirs) == 7 and ours.paths == theirs.paths
    for i in range(7):
        assert len(ours[i]) == 1 and _same(ours[i][0], theirs[i][0])
    assert float(np.abs(ours[5][0]).max()) == 0.0  # the flat volume scales to zeros
    with pytest.raises(ValueError, match="no NIfTI volumes"):
        tvol.UnlabeledVolumeDataset(str(tmp_path))


@pytest.mark.parametrize("kw", [
    dict(batch_size=2), dict(batch_size=3, drop_last=False), dict(batch_size=2, shuffle=False),
    dict(batch_size=2, seed=5, num_hosts=2, host_id=1), dict(batch_size=4, num_hosts=3, host_id=2, drop_last=False),
])
def test_loader_order_over_epochs_is_the_references(decathlon, kw):
    images, labels, _ = decathlon
    ours = tvol.VolumeLoader(tvol.DecathlonVolumeDataset(images, labels, target_shape=(6, 6, 6), cache=True), **kw)
    theirs = jvol.VolumeLoader(jvol.DecathlonVolumeDataset(images, labels, target_shape=(6, 6, 6), cache=True), **kw)
    assert len(ours) == len(theirs)
    for epoch in range(3):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours) and ours.epoch == theirs.epoch == epoch + 1
        for g, w in zip(got, want):
            assert len(g) == 2 and all(_same(a, b) for a, b in zip(g, w))


def test_index_batches_are_the_batches_of_iter_and_bump_the_epoch(decathlon):
    images, labels, _ = decathlon
    ds = tvol.DecathlonVolumeDataset(images, labels, target_shape=(6, 6, 6), cache=True)
    by_iter, by_index = tvol.VolumeLoader(ds, 3, seed=2), tvol.VolumeLoader(ds, 3, seed=2)
    ref = jvol.VolumeLoader(ds, 3, seed=2)
    for epoch in range(2):
        idx = list(by_index.iter_index_batches())
        assert by_index.epoch == epoch + 1
        assert all(i.dtype == np.int32 for i in idx)
        assert all(np.array_equal(a, b) for a, b in zip(idx, ref.iter_index_batches()))
        for (vols, msks), chunk in zip(by_iter, idx):
            assert _same(vols, np.stack([ds[int(i)][0] for i in chunk]))
            assert _same(msks, np.stack([ds[int(i)][1] for i in chunk]))
    by_index.epoch = 0  # a resume sets the counter before the first iter()
    assert np.array_equal(np.concatenate(list(by_index.iter_index_batches())),
                          np.concatenate(list(tvol.VolumeLoader(ds, 3, seed=2).iter_index_batches())))


def test_unlabeled_loader_yields_one_tuples(decathlon):
    images, _, _ = decathlon
    ours = tvol.VolumeLoader(tvol.UnlabeledVolumeDataset(images, target_shape=(6, 6, 6)), 2, seed=1)
    theirs = jvol.VolumeLoader(jvol.UnlabeledVolumeDataset(images, target_shape=(6, 6, 6)), 2, seed=1)
    for g, w in zip(ours, theirs):
        assert len(g) == len(w) == 1 and g[0].shape == (2, 6, 6, 6, 1) and _same(g[0], w[0])
