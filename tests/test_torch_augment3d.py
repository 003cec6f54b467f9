"""The port's volumetric augmentation against the JAX package's, on the CPU.

The torch random stream cannot match JAX's, so the JAX draws (crop origins,
flip coins, brightness and contrast factors, made from the same keys in the
same order as ``ops/augment3d.py:62-85`` and ``:101-116``) are fed into the
port's ``apply_*``. f32 on both sides. Masks must be exactly equal; images
are held to 1e-5 absolute on the normalized scale (values of a few units),
which leaves room for the order of the contrast mean's sum and nothing
else. The port's own sampler is checked for its ranges, its shapes and the
rule that an axis where volume and crop are equal draws nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.ops import augment3d as jaug
from medical_image_segmentation_tpu_torch.ops import augment3d as taug

TOL = 1e-5
MEAN, STD = (0.2089,), (0.2109,)
HU = ((0.5, 0.4), (0.3, 0.2), (0.7, 0.6))


def _volumes(seed, b=3, dims=(12, 18, 20)):
    rng = np.random.default_rng(seed)
    vols = rng.random((b, *dims, 1)).astype(np.float32)
    masks = (rng.random((b, *dims, 1)) < 0.4).astype(np.float32)
    return vols, masks


def _jax_draws(key, b, in_dims, out_size):
    """The draws ``segmentation_augment_3d`` / ``_byol_view_3d`` make from ``key``."""
    kcrop, kflip, kb, kc = jax.random.split(key, 4)
    return {
        "offsets": torch.from_numpy(np.array(jaug._crop_offsets(kcrop, b, in_dims, out_size, True))).long(),
        "flips": torch.from_numpy(np.array(jax.random.uniform(kflip, (b, 3)) < 0.5)),
        "brightness": torch.from_numpy(np.array(jax.random.uniform(kb, (b,), minval=0.8, maxval=1.2))),
        "contrast": torch.from_numpy(np.array(jax.random.uniform(kc, (b,), minval=0.8, maxval=1.2))),
    }


@pytest.mark.parametrize("hu_windows", [(), HU], ids=["plain", "hu_windows"])
@pytest.mark.parametrize("out_size", [(8, 16, 16), (12, 16, 20), (12, 18, 20)], ids=["crop", "depth_equal", "all_equal"])
@pytest.mark.parametrize("seed", [0, 1])
def test_train_pipeline_matches_jax_on_its_draws(seed, out_size, hu_windows):
    vols, masks = _volumes(seed)
    key = jax.random.key(seed + 10)
    want_img, want_msk = jaug.segmentation_augment_3d(key, jnp.asarray(vols), jnp.asarray(masks), out_size=out_size,
                                                      mean=MEAN, std=STD, train=True, dtype=jnp.float32,
                                                      hu_windows=hu_windows)
    draws = _jax_draws(key, vols.shape[0], vols.shape[1:4], out_size)
    assert draws["flips"].any() and not draws["flips"].all()  # both branches of the flip run
    img, msk = taug.apply_segmentation_3d(draws, torch.from_numpy(vols), torch.from_numpy(masks), out_size, MEAN, STD,
                                          dtype=torch.float32, hu_windows=hu_windows)
    assert img.shape == (3, *out_size, len(hu_windows) or 1) and msk.shape == (3, *out_size, 1)
    assert np.array_equal(msk.numpy(), np.asarray(want_msk))
    assert float(np.abs(img.numpy() - np.asarray(want_img)).max()) <= TOL


@pytest.mark.parametrize("hu_windows", [(), HU], ids=["plain", "hu_windows"])
def test_eval_pipeline_is_the_centre_crop_and_draws_nothing(hu_windows):
    vols, masks = _volumes(2)
    out_size = (8, 16, 16)
    want_img, want_msk = jaug.segmentation_augment_3d(jax.random.key(0), jnp.asarray(vols), jnp.asarray(masks),
                                                      out_size=out_size, mean=MEAN, std=STD, train=False,
                                                      dtype=jnp.float32, hu_windows=hu_windows)
    img, msk = taug.segmentation_augment_3d(None, torch.from_numpy(vols), torch.from_numpy(masks), out_size, MEAN, STD,
                                            train=False, dtype=torch.float32, hu_windows=hu_windows)
    assert np.array_equal(msk.numpy(), np.asarray(want_msk))
    assert float(np.abs(img.numpy() - np.asarray(want_img)).max()) <= TOL
    centre = vols[:, 2:10, 1:17, 2:18]
    if not hu_windows:
        assert float(np.abs(img.numpy() - (centre - MEAN[0]) / STD[0]).max()) <= TOL


def test_soft_masks_are_cut_at_half_after_the_crop_and_value_scale_applies():
    vols, _ = _volumes(3)
    soft = np.random.default_rng(4).random(vols.shape).astype(np.float32)
    key = jax.random.key(5)
    want_img, want_msk = jaug.segmentation_augment_3d(key, jnp.asarray(vols * 255), jnp.asarray(soft), out_size=(8, 16, 16),
                                                      mean=MEAN, std=STD, train=True, value_scale=1 / 255.0,
                                                      dtype=jnp.float32)
    draws = _jax_draws(key, 3, vols.shape[1:4], (8, 16, 16))
    img, msk = taug.apply_segmentation_3d(draws, torch.from_numpy(vols * 255), torch.from_numpy(soft), (8, 16, 16),
                                          MEAN, STD, value_scale=1 / 255.0, dtype=torch.float32)
    assert np.array_equal(msk.numpy(), np.asarray(want_msk)) and set(np.unique(msk.numpy())) == {0.0, 1.0}
    assert float(np.abs(img.numpy() - np.asarray(want_img)).max()) <= TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_byol_two_views_match_jax_on_their_draws(seed):
    vols, _ = _volumes(seed, b=2, dims=(10, 20, 18))
    out_size = (8, 16, 16)
    key = jax.random.key(seed)
    want = jaug.byol_two_view_augment_3d(key, jnp.asarray(vols), out_size=out_size, mean=MEAN, std=STD,
                                         dtype=jnp.float32)
    for k, w in zip(jax.random.split(key), want):
        draws = _jax_draws(k, 2, vols.shape[1:4], out_size)
        got = taug.apply_byol_view_3d(draws, torch.from_numpy(vols), out_size, MEAN, STD, dtype=torch.float32)
        assert got.shape == (2, *out_size, 1)
        assert float(np.abs(got.numpy() - np.asarray(w)).max()) <= TOL
    assert float(np.abs(np.asarray(want[0]) - np.asarray(want[1])).max()) > 0.1  # two different views


def test_output_dtype_is_the_one_asked_for():
    vols, masks = _volumes(6)
    gen = torch.Generator().manual_seed(0)
    img, msk = taug.segmentation_augment_3d(gen, torch.from_numpy(vols), torch.from_numpy(masks), (8, 16, 16))
    v1, v2 = taug.byol_two_view_augment_3d(gen, torch.from_numpy(vols), (8, 16, 16))
    assert img.dtype == v1.dtype == v2.dtype == torch.bfloat16 and msk.dtype == torch.float32
    assert not torch.equal(v1, v2)


@pytest.mark.parametrize("fn", ["segmentation", "byol", "sampler"])
def test_a_crop_larger_than_the_volume_raises_the_references_error(fn):
    vols, masks = _volumes(7, dims=(6, 18, 20))
    with pytest.raises(ValueError, match=r"volume dim 0 \(6\) smaller than crop \(8\); pad on host"):
        jaug.segmentation_augment_3d(jax.random.key(0), jnp.asarray(vols), jnp.asarray(masks), out_size=(8, 16, 16))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match=r"volume dim 0 \(6\) smaller than crop \(8\); pad on host"):
        if fn == "segmentation":
            taug.segmentation_augment_3d(None, torch.from_numpy(vols), torch.from_numpy(masks), (8, 16, 16), train=False)
        elif fn == "byol":
            taug.byol_two_view_augment_3d(gen, torch.from_numpy(vols), (8, 16, 16))
        else:
            taug.sample_volume_draws(gen, 3, (6, 18, 20), (8, 16, 16))


def test_sampler_ranges_and_shapes():
    gen = torch.Generator().manual_seed(1)
    d = taug.sample_volume_draws(gen, 4096, (12, 18, 20), (8, 16, 16))
    assert d["offsets"].shape == (4096, 3) and d["offsets"].dtype == torch.int64
    assert d["flips"].shape == (4096, 3) and d["flips"].dtype == torch.bool
    for ax, hi in enumerate((4, 2, 4)):  # every origin of the valid range is drawn, none outside it
        assert sorted(d["offsets"][:, ax].unique().tolist()) == list(range(hi + 1))
    assert 0.45 < float(d["flips"].float().mean()) < 0.55
    for k in ("brightness", "contrast"):
        assert d[k].shape == (4096,) and 0.8 <= float(d[k].min()) and float(d[k].max()) < 1.2
        assert float(d[k].max()) - float(d[k].min()) > 0.39


def test_sampler_draws_nothing_on_an_axis_where_volume_and_crop_are_equal():
    """The JAX sampler draws an origin only where the volume is larger than
    the crop; the stream after an equal axis is the stream without it."""
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    with_equal = taug.sample_volume_draws(a, 8, (8, 18, 20), (8, 16, 16))
    assert torch.equal(with_equal["offsets"][:, 0], torch.zeros(8, dtype=torch.int64))
    hw = [torch.randint(0, n, (8,), generator=b) for n in (3, 5)]
    assert torch.equal(with_equal["offsets"][:, 1], hw[0]) and torch.equal(with_equal["offsets"][:, 2], hw[1])
    assert torch.equal(with_equal["flips"], torch.rand(8, 3, generator=b) < 0.5)
    all_equal = taug.sample_volume_draws(torch.Generator().manual_seed(3), 8, (8, 16, 16), (8, 16, 16))
    assert not all_equal["offsets"].any()
    assert torch.equal(all_equal["flips"], torch.rand(8, 3, generator=torch.Generator().manual_seed(3)) < 0.5)
