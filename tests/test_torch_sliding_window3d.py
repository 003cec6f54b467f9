"""The port's 3D sliding-window inference against the JAX package's loop
variant, on the CPU.

- ``sliding_window_predict_3d`` with the same converted ``UNet3D``
  (``features=(4, 8)``, f32) on a volume smaller than the window, one equal
  to it and one whose last window on every axis is ragged (right-aligned):
  the blended logits agree to 1e-5 of the largest logit (the two
  convolutions sum in another order; the blend itself is the same
  arithmetic).
- The same three volumes and an explicit stride with a window function that
  is one closed form on both sides and depends on the position inside the
  window, so the Hann blend, the padded tail and the crop back are held on
  their own: f32, atol 1e-6.
- ``window_grid_3d`` / ``count_windows_3d`` against the reference's grid and
  the count its CLI computes (``train/predict3d.py:143-145``): exact.
- One window blended is the plain eval forward, to 1e-5 of the largest
  logit (the window batch is padded to 4, and a convolution may sum in
  another order at batch 4 than at batch 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.eval import sliding_window as jsw
from medical_image_segmentation_tpu.models.unet3d import UNet3D as JaxUNet3D
from medical_image_segmentation_tpu_torch.core.convert import unet3d_flax_to_state_dict
from medical_image_segmentation_tpu_torch.eval import sliding_window as tsw
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

torch.set_num_threads(2)

WINDOW = (8, 16, 16)
FEATURES = (4, 8)
# smaller than the window on two axes; exactly one window; ragged last windows
VOLUMES = [(5, 16, 12), WINDOW, (13, 27, 22)]


@pytest.fixture(scope="module")
def models():
    jm = JaxUNet3D(features=FEATURES, dtype=jnp.float32)
    variables = jax.device_get(jm.init(jax.random.key(0), jnp.zeros((1, *WINDOW, 1)), train=True))
    task = Segmentation3DTask(features=FEATURES, dtype=torch.float32, device="cpu")
    task.model.load_state_dict(unet3d_flax_to_state_dict(variables["params"], {}))
    jax_fn = jax.jit(lambda w: jm.apply(variables, w, train=False))
    return jax_fn, task


def _volume(dims, channels=1, seed=0):
    return np.random.default_rng(seed).standard_normal((*dims, channels)).astype(np.float32)


@pytest.mark.parametrize("dims", VOLUMES)
def test_predict_3d_matches_the_jax_loop_with_the_same_model(models, dims):
    jax_fn, task = models
    x = _volume(dims)
    want = np.asarray(jsw.sliding_window_predict_3d(jax_fn, jnp.asarray(x), WINDOW, batch_windows=4))
    got = tsw.sliding_window_predict_3d(task.logits, torch.from_numpy(x), WINDOW, batch_windows=4)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (*dims, 1)
    assert float(np.abs(got.numpy() - want).max() / np.abs(want).max()) <= 1e-5


def _jax_window_fn(w):
    """(N, d, h, w, C) → (N, d, h, w, 2): depends on the position inside the window."""
    d, h = w.shape[1], w.shape[2]
    rz = jnp.arange(d, dtype=jnp.float32).reshape(1, d, 1, 1, 1) / d
    ry = jnp.arange(h, dtype=jnp.float32).reshape(1, 1, h, 1, 1) / h
    a = jnp.tanh(w.mean(axis=-1, keepdims=True))
    return jnp.concatenate([a * rz + ry, a - rz * ry], axis=-1)


def _torch_window_fn(w):
    d, h = w.shape[1], w.shape[2]
    rz = torch.arange(d, dtype=torch.float32).reshape(1, d, 1, 1, 1) / d
    ry = torch.arange(h, dtype=torch.float32).reshape(1, 1, h, 1, 1) / h
    a = torch.tanh(w.mean(dim=-1, keepdim=True))
    return torch.cat([a * rz + ry, a - rz * ry], dim=-1)


@pytest.mark.parametrize("dims,stride,batch", [(VOLUMES[0], None, 4), (VOLUMES[1], None, 3), (VOLUMES[2], None, 4),
                                               (VOLUMES[2], (3, 10, 16), 5)])
def test_blend_pad_and_crop_match_the_jax_loop(dims, stride, batch):
    x = _volume(dims, channels=2, seed=1)
    want = jsw.sliding_window_predict_3d(_jax_window_fn, jnp.asarray(x), WINDOW, stride=stride, batch_windows=batch,
                                         num_classes=2)
    got = tsw.sliding_window_predict_3d(_torch_window_fn, torch.from_numpy(x), WINDOW, stride=stride,
                                        batch_windows=batch, num_classes=2)
    assert tuple(got.shape) == want.shape == (*dims, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("dims,window,n", [((5, 16, 12), WINDOW, 1), (WINDOW, WINDOW, 1), ((13, 27, 22), WINDOW, 18),
                                           ((80, 160, 160), (32, 64, 64), 64), ((64, 96, 96), (32, 64, 64), 12),
                                           ((33, 64, 65), (32, 64, 64), 4)])
def test_count_and_grid_match_the_reference(dims, window, n):
    starts = [jsw._window_starts(max(full, w), w, max(1, w // 2)) for full, w in zip(dims, window)]
    count = 1  # the JAX CLI's own count
    for s in starts:
        count *= len(s)
    assert tsw.count_windows_3d(dims, window) == count == n
    grid = tsw.window_grid_3d(dims, window)
    assert grid.dtype == np.int32
    np.testing.assert_array_equal(grid, [(z, y, x) for z in starts[0] for y in starts[1] for x in starts[2]])
    # every window lies inside the padded volume and the last is right-aligned
    padded = np.maximum(dims, window)
    assert (grid >= 0).all() and (grid + np.array(window) <= padded).all()
    np.testing.assert_array_equal(grid[-1] + np.array(window), padded)


def test_an_explicit_stride_changes_the_grid_as_in_the_reference():
    dims, stride = (13, 27, 22), (2, 5, 4)
    starts = [jsw._window_starts(full, w, s) for full, w, s in zip(dims, WINDOW, stride)]
    assert tsw.count_windows_3d(dims, WINDOW, stride) == len(starts[0]) * len(starts[1]) * len(starts[2])
    assert tsw.count_windows_3d(dims, WINDOW, stride) != tsw.count_windows_3d(dims, WINDOW)


def test_one_window_is_the_plain_forward(models):
    _, task = models
    x = torch.from_numpy(_volume(WINDOW, seed=2))
    got = tsw.sliding_window_predict_3d(task.logits, x, WINDOW)
    want = task.logits(x[None])[0]
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_every_forward_sees_one_shape_and_the_tail_is_not_blended():
    """18 windows in batches of 4: five forwards of 4 windows; the repeats
    of the last window add nothing (a function that counts calls)."""
    shapes = []

    def fn(w):
        shapes.append(tuple(w.shape))
        return torch.ones(*w.shape[:4], 1)

    out = tsw.sliding_window_predict_3d(fn, torch.zeros(13, 27, 22, 1), WINDOW, batch_windows=4)
    assert shapes == [(4, *WINDOW, 1)] * 5
    # a constant function blends to the constant wherever the weights are not tiny
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-5)
