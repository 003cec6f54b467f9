"""The port's fused sliding-window predictors, on the CPU (where they run
the captured function eagerly), against the port's loop and against the JAX
package's fused predictors. The twin of ``tests/test_sliding_window.py:84-128``.

Window functions are closed forms that depend on the position inside the
window (so the Hann blend, the padded tail batch and the zero padding of a
small input all matter) or the identity and ``2×`` of the JAX tests. f32
throughout. Against the loop: relative 1e-6 (equal is expected: the same
products are added in the same order). Against JAX: 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.eval import sliding_window as jsw
from medical_image_segmentation_tpu_torch.eval import sliding_window as tsw

torch.set_num_threads(2)


def _ramp(lib, w, axis):
    s = w.shape[axis]
    shape = [1] * w.ndim
    shape[axis] = s
    return (lib.arange(s, dtype=lib.float32) / s).reshape(shape)


def _position_fn(lib):
    """(N, *window, C) → (N, *window, 2), varying along the first window axis."""
    def fn(w):
        ramp = _ramp(lib, w, 1)
        a = lib.tanh(w.sum(-1)[..., None])
        parts = [a * ramp, a - ramp]
        return lib.cat(parts, -1) if lib is torch else lib.concatenate(parts, -1)
    return fn


FNS = {
    "position": (_position_fn(torch), _position_fn(jnp), 2),
    "identity": (lambda w: w[..., :1], lambda w: w[..., :1], 1),
    "double": (lambda w: w[..., :1] * 2.0, lambda w: w[..., :1] * 2.0, 1),
}

# (shape, window, stride, batch_windows): ragged sizes, an input smaller than
# its window, a window count that does not fill the last batch, an explicit stride
CASES_2D = [((70, 53, 2), 32, 0, 16), ((20, 90, 1), 32, 0, 5), ((64, 64, 1), 32, 0, 4), ((75, 40, 2), 32, 11, 3),
            ((33, 32, 1), 32, 0, 16)]
CASES_3D = [((20, 30, 26, 1), (8, 16, 16), (4, 8, 8), 3), ((12, 24, 24, 1), (8, 16, 16), None, 4),
            ((4, 10, 10, 1), (8, 16, 16), None, 8), ((9, 40, 18, 2), (8, 16, 16), (3, 5, 7), 5)]


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("shape,window,stride,batch", CASES_2D)
def test_fused_2d_matches_the_loop_and_the_jax_fused_predictor(shape, window, stride, batch, fn):
    tfn, jfn, k = FNS[fn]
    x = _input(shape)
    fused = tsw.make_fused_predictor_2d(tfn, shape, window, stride=stride, batch_windows=batch, num_classes=k,
                                        device="cpu")
    got = fused(torch.from_numpy(x))
    assert tuple(got.shape) == (*shape[:2], k)
    assert fused.n_windows == tsw.count_windows(shape[0], shape[1], window, stride)
    loop = tsw.sliding_window_predict(tfn, torch.from_numpy(x), window, stride=stride, batch_windows=batch,
                                      num_classes=k)
    _assert_close(got.numpy(), loop.numpy(), 1e-6)
    want = jsw.make_fused_predictor_2d(jfn, shape, window, stride=stride, batch_windows=batch, num_classes=k)
    _assert_close(got.numpy(), want(jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("shape,window,stride,batch", CASES_3D)
def test_fused_3d_matches_the_loop_and_the_jax_fused_predictor(shape, window, stride, batch, fn):
    tfn, jfn, k = FNS[fn]
    x = _input(shape, seed=1)
    fused = tsw.make_fused_predictor_3d(tfn, shape, window, stride=stride, batch_windows=batch, num_classes=k,
                                        device="cpu")
    got = fused(torch.from_numpy(x))
    assert tuple(got.shape) == (*shape[:3], k)
    assert fused.n_windows == tsw.count_windows_3d(shape[:3], window, stride)
    loop = tsw.sliding_window_predict_3d(tfn, torch.from_numpy(x), window, stride=stride, batch_windows=batch,
                                         num_classes=k)
    _assert_close(got.numpy(), loop.numpy(), 1e-6)
    want = jsw.make_fused_predictor_3d(jfn, shape, window, stride=stride, batch_windows=batch, num_classes=k)
    _assert_close(got.numpy(), want(jnp.asarray(x)), 1e-5)


def test_the_identity_is_reconstructed_and_padded_windows_add_nothing():
    """18 windows in batches of 4: the two repeats of the last window must
    not be blended, or the identity would not come back."""
    x = torch.from_numpy(_input((12, 32, 32, 1), seed=4))
    fused = tsw.make_fused_predictor_3d(lambda w: w, x.shape, (8, 16, 16), batch_windows=4, device="cpu")
    assert fused.n_windows == 18 and sum(len(b) for b in fused._batches) == 20
    _assert_close(fused(x).numpy(), x.numpy(), 1e-5)


def test_every_forward_sees_one_batch_shape_and_the_input_shape_is_checked():
    seen = []

    def fn(w):
        seen.append(tuple(w.shape))
        return w

    fused = tsw.make_fused_predictor_2d(fn, (70, 53, 1), 32, batch_windows=16, device="cpu")
    fused(torch.zeros(70, 53, 1))
    assert seen == [(16, 32, 32, 1)]  # 4·3 = 12 windows padded to 16
    with pytest.raises(ValueError, match=r"built for inputs of shape \(70, 53, 1\)"):
        fused(torch.zeros(70, 54, 1))
    assert fused.replays == 0 and fused.capture_seconds == 0.0  # no graph off the card
    with pytest.raises(TypeError, match="device"):  # the device is never guessed
        tsw.make_fused_predictor_2d(fn, (70, 53, 1), 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsw.make_fused_predictor_2d(fn, (70, 53, 1), 32, device="cuda")


def test_the_cache_keys_on_shape_and_keeps_the_most_recent_shapes(monkeypatch):
    made = []

    def make(shape):
        made.append(shape)
        return tsw.make_fused_predictor_2d(lambda w: w * 2.0, shape, 32, device="cpu")

    monkeypatch.setattr(tsw.FusedCache, "MAX_SHAPES", 2)
    cache = tsw.FusedCache(make)
    a, b, c = (torch.ones(s) for s in ((40, 40, 1), (50, 40, 1), (33, 70, 1)))
    for x in (a, a, b, a):
        np.testing.assert_allclose(cache(x).numpy(), 2.0, rtol=1e-6)
    assert made == [(40, 40, 1), (50, 40, 1)] and cache.built == 2 and len(cache) == 2
    cache(c)  # evicts b, the least recently served
    cache(a)
    assert made[2:] == [(33, 70, 1)] and len(cache) == 2
    cache(b)
    assert made[3:] == [(50, 40, 1)] and cache.built == 4
