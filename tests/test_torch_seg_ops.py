"""The port's Dice/IoU ops and paired segmentation augmentation against the
JAX package's, on the CPU.

Both sides get the same numpy inputs. The augmentation is compared on
identical randomness: the test draws the flips and jitter factors from the
JAX keys exactly as ``segmentation_augment`` does (``kh, kv, kb, kc``) and
hands them to the port's ``apply_segmentation``. f32 on both sides.
Tolerances: the losses and metrics to atol 1e-6 (single f32 sums over a
few thousand values); masks exactly; images to atol 1e-5 (a few f32
roundings of values of order 1, in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from medical_image_segmentation_tpu.ops import augment as jaug
from medical_image_segmentation_tpu.ops import dice as jdice
from medical_image_segmentation_tpu_torch.ops import augment as taug
from medical_image_segmentation_tpu_torch.ops import dice as tdice

torch.set_num_threads(2)

B = 3


@pytest.fixture(scope="module")
def logits_and_masks():
    rng = np.random.default_rng(0)
    logits = (2.0 * rng.standard_normal((B, 16, 16, 1))).astype(np.float32)
    masks = (rng.random((B, 16, 16, 1)) < 0.3).astype(np.float32)
    return logits, masks


@pytest.mark.parametrize("name", ["dice_loss", "dice_ce", "post_process_masks", "dice_coefficient", "jaccard_index"])
def test_dice_ops_match_jax(logits_and_masks, name):
    logits, masks = logits_and_masks
    jl, jm, tl, tm = jnp.asarray(logits), jnp.asarray(masks), torch.from_numpy(logits), torch.from_numpy(masks)
    if name == "dice_ce":
        want = jdice.dice_loss(jl, jm) + optax.sigmoid_binary_cross_entropy(jl, jm).mean()
        got = tdice.dice_ce(tl, tm)
    elif name == "post_process_masks":
        want, got = jdice.post_process_masks(jl, 0.3), tdice.post_process_masks(tl, 0.3)
    elif name in ("dice_coefficient", "jaccard_index"):
        jp, tp = jdice.post_process_masks(jl), tdice.post_process_masks(tl)
        want, got = getattr(jdice, name)(jp, jm), getattr(tdice, name)(tp, tm)
    else:
        want, got = jdice.dice_loss(jl, jm), tdice.dice_loss(tl, tm)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_dice_loss_sums_in_f32_for_bf16_logits(logits_and_masks):
    logits, masks = logits_and_masks
    bf = torch.from_numpy(logits).bfloat16()
    want = jdice.dice_loss(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(masks))
    np.testing.assert_allclose(tdice.dice_loss(bf, torch.from_numpy(masks)).numpy(), np.asarray(want), atol=1e-6)


def _jax_draws(key, b):
    """The draws of ``segmentation_augment`` from its key, for the port."""
    kh, kv, kb, kc = jax.random.split(key, 4)
    return {
        "hflip": torch.from_numpy(np.array(jax.random.uniform(kh, (b,)) < 0.5)),
        "vflip": torch.from_numpy(np.array(jax.random.uniform(kv, (b,)) < 0.5)),
        "brightness": torch.from_numpy(np.array(jax.random.uniform(kb, (b, 1, 1, 1), minval=0.8, maxval=1.2))
                                       .reshape(b)),
        "contrast": torch.from_numpy(np.array(jax.random.uniform(kc, (b, 1, 1, 1), minval=0.8, maxval=1.2))
                                     .reshape(b)),
    }


WINDOWS = ((0.4, 0.5), (0.7, 0.3))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("hu_windows", [(), WINDOWS])
@pytest.mark.parametrize("in_hw", [(64, 64), (80, 72)])
def test_segmentation_augment_matches_jax(train, hu_windows, in_hw):
    rng = np.random.default_rng(1)
    b = 4
    images = rng.integers(0, 256, size=(b, *in_hw, 1), dtype=np.uint8)
    masks = (rng.random((b, *in_hw, 1)) < 0.4).astype(np.uint8)
    key = jax.random.key(1)
    kw = dict(out_size=(64, 64), mean=(0.2089,), std=(0.2109,))
    jimg, jmsk = jaug.segmentation_augment(key, jnp.asarray(images), jnp.asarray(masks), train=train,
                                           dtype=jnp.float32, hu_windows=hu_windows, **kw)
    draws = _jax_draws(key, b) if train else None
    if train:  # the case must exercise both flips in both states
        assert 0 < int(draws["hflip"].sum()) < b and 0 < int(draws["vflip"].sum()) < b
    timg, tmsk = taug.apply_segmentation(draws, torch.from_numpy(images), torch.from_numpy(masks),
                                         dtype=torch.float32, hu_windows=hu_windows, **kw)
    assert timg.dtype == torch.float32 and tuple(timg.shape) == jimg.shape == (b, 64, 64, len(hu_windows) or 1)
    np.testing.assert_array_equal(tmsk.numpy(), np.asarray(jmsk))
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=1e-5)


def test_segmentation_augment_samples_the_draws_it_applies():
    images = torch.from_numpy(np.random.default_rng(2).integers(0, 256, size=(5, 32, 32, 1), dtype=np.uint8))
    masks = (images > 128).float()
    a = taug.segmentation_augment(torch.Generator().manual_seed(4), images, masks, (32, 32), dtype=torch.float32)
    draws = taug.sample_segmentation_draws(torch.Generator().manual_seed(4), 5)
    b = taug.apply_segmentation(draws, images, masks, (32, 32), dtype=torch.float32)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert set(draws) == {"hflip", "vflip", "brightness", "contrast"}
    assert all(0.8 <= float(v) < 1.2 for k in ("brightness", "contrast") for v in draws[k])
    ev = taug.segmentation_augment(None, images, masks, (32, 32), train=False, dtype=torch.float32)
    assert torch.equal(ev[1], masks)  # no flips at eval, identity resize


def test_nearest_matrix_rounds_half_to_even_like_jax():
    """The mask-resize hazard: F.interpolate's nearest picks floor(i·scale)
    and would move a mask by a pixel at this size; the port picks what
    JAX picks."""
    start, size = np.zeros(2, np.float32), np.full(2, 100.0, np.float32)
    want = np.asarray(jaug._nearest_matrix(jnp.asarray(start), jnp.asarray(size), 100, 64))
    got = taug._nearest_matrix(torch.from_numpy(start), torch.from_numpy(size), 100, 64).numpy()
    np.testing.assert_array_equal(got, want)
    floor_src = F.interpolate(torch.arange(100.0).view(1, 1, -1), size=64, mode="nearest").view(-1).numpy()
    assert not np.array_equal(floor_src, want[0].argmax(-1))


def test_apply_hu_windows_matches_jax():
    x = np.random.default_rng(5).random((2, 8, 8, 1)).astype(np.float32)
    want = jaug.apply_hu_windows(jnp.asarray(x), WINDOWS)
    got = taug.apply_hu_windows(torch.from_numpy(x), WINDOWS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    xt = torch.from_numpy(x)
    assert taug.apply_hu_windows(xt, ()) is xt


@pytest.mark.parametrize("spec,value_max", [("96:160,40:80", 255.0), (" 1000:2000 , ,30000:8000", 65535.0)])
def test_parse_hu_windows_matches_jax(spec, value_max):
    assert taug.parse_hu_windows(spec, value_max) == jaug.parse_hu_windows(spec, value_max)


@pytest.mark.parametrize("spec,message", [("96", "expected LEVEL:WIDTH"), ("a:b", "expected LEVEL:WIDTH"),
                                          ("96:0", "width must be > 0"), (" , ", "no windows")])
def test_parse_hu_windows_errors_match_jax(spec, message):
    with pytest.raises(ValueError, match=message) as tinfo:
        taug.parse_hu_windows(spec)
    with pytest.raises(ValueError) as jinfo:
        jaug.parse_hu_windows(spec)
    assert str(tinfo.value) == str(jinfo.value)
