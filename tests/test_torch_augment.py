"""The port's two-view augmentation against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. Where
randomness is involved, the JAX draws are injected into the port: the
fused path takes the (B, 24) block of the JAX ``sample_view_params``, the
plain path takes the draws JAX's ``augment_view`` makes from its keys. The
JAX Pallas kernel runs as ``tests/test_pallas_augment.py`` runs it, in
interpret mode. Everything is f32 here; atol 1e-3 on normalized values
(~1/60 of a grey level) covers the matmul-vs-gather summation order of a
bilinear tap pair. The kernel itself is tested on the card by
``tests/test_torch_kernels.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.ops import augment as jaug
from medical_image_segmentation_tpu.ops.pallas_augment import (
    pallas_supported,
    pallas_two_view_augment,
)
from medical_image_segmentation_tpu.ops.pallas_augment import sample_view_params as jax_sample_view_params
from medical_image_segmentation_tpu_torch.ops import augment as taug
from medical_image_segmentation_tpu_torch.ops import fused_augment as fa
from test_pallas_augment import _reference_views

torch.set_num_threads(2)

ATOL = 1e-3


def _cfgs(base: str, **changes):
    """The same ViewConfig in both packages: (jax, torch)."""
    return (dataclasses.replace(getattr(jaug, base), **changes),
            dataclasses.replace(getattr(taug, base), **changes))


# --------------------------------------------------------------- configs


def test_viewconfig_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jaug.ViewConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(taug.ViewConfig)]
    assert tf == jf


@pytest.mark.parametrize("name", ["BYOL_VIEW1", "BYOL_VIEW2", "BYOL_TV_VIEW1", "BYOL_TV_VIEW2"])
def test_canonical_view_configs_match_jax(name):
    assert dataclasses.asdict(getattr(taug, name)) == dataclasses.asdict(getattr(jaug, name))


# Every case of test_pallas_augment.py::TestPallasGate::test_reachable_configs.
GATE_CASES = [
    ("BYOL_VIEW1", {}, 1),
    ("BYOL_VIEW2", {}, 1),
    ("BYOL_VIEW1", {}, 3),
    ("BYOL_VIEW1", {}, 2),
    ("BYOL_TV_VIEW1", {}, 1),
    ("BYOL_VIEW1", {"window_prob": 0.5}, 1),
    ("BYOL_VIEW1", {"window_level_range": (10.0, 20.0)}, 1),
    ("BYOL_VIEW1", {"blur_prob": 1.0}, 1),
    ("BYOL_VIEW1", {"jitter_prob": 0.8, "brightness": 0.4}, 3),
]


@pytest.mark.parametrize("base,changes,channels", GATE_CASES)
def test_fused_gate_matches_pallas_gate(base, changes, channels):
    jcfg, tcfg = _cfgs(base, **changes)
    assert fa.fused_supported(tcfg, channels) == pallas_supported(jcfg, channels)


def test_fused_gate_refuses_unknown_field():
    @dataclasses.dataclass(frozen=True)
    class Extended(taug.ViewConfig):
        cutout_prob: float = 0.0

    assert fa.fused_supported(taug.BYOL_VIEW1, 1)
    assert not fa.fused_supported(Extended(), 1)


# ------------------------------------------------ fused path vs Pallas


def _u16_cfg():
    return dict(out_size=(32, 32), solarize_prob=0.5, solarize_threshold=128.0 * 257,
                window_prob=0.7, window_level_range=(96.0 * 257, 160.0 * 257),
                window_width_range=(128.0 * 257, 255.0 * 257), value_max=65535.0)


# (name, image shape, dtype, cfg changes, mean, std, seed) — the cases of
# test_pallas_augment.py::TestPallasAugment
FUSED_CASES = [
    ("gray", (4, 64, 64), np.uint8, dict(out_size=(32, 32), solarize_prob=0.5), (57.9764,), (60.4759,), 1),
    ("ct_window", (8, 48, 48), np.uint8,
     dict(out_size=(24, 24), solarize_prob=0.3, window_prob=0.7), (57.9764,), (60.4759,), 4),
    ("rgb_gray", (6, 40, 40, 3), np.uint8, dict(out_size=(16, 16), solarize_prob=0.4, grayscale_prob=0.6),
     (125.3, 123.0, 113.9), (63.0, 62.1, 66.7), 6),
    ("u16", (4, 48, 48), np.uint16, _u16_cfg(), (57.9764 * 257,), (60.4759 * 257,), 5),
    ("flip", (2, 32, 32), np.uint8,
     dict(out_size=(32, 32), crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0), hflip_prob=1.0), (0.0,), (1.0,), 2),
]


@pytest.mark.parametrize("name,shape,dtype,changes,mean,std,seed", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_reference_matches_pallas(name, shape, dtype, changes, mean, std, seed):
    images = np.random.default_rng(seed).integers(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)
    jcfg, tcfg = _cfgs("BYOL_VIEW1", **changes)
    key = jax.random.key(seed)
    b, h, w = shape[:3]
    params = np.array(jax_sample_view_params(key, b, h, w, jcfg, jcfg))
    pallas = pallas_two_view_augment(key, jnp.asarray(images), jcfg, jcfg, mean=mean, std=std,
                                     dtype=jnp.float32, interpret=True)
    img4 = images if images.ndim == 4 else images[..., None]
    xla = _reference_views(jnp.asarray(params), jnp.asarray(img4), jcfg.out_size, mean, std,
                           vmax=jcfg.value_max)
    before = fa.fused_two_view_augment.launches
    ours = fa.fused_two_view_augment(torch.from_numpy(images), tcfg, tcfg, mean, std, torch.float32,
                                     params=torch.from_numpy(params))
    assert fa.fused_two_view_augment.launches == before  # CPU tensors: plain version, no launch
    for o, p, x in zip(ours, pallas, xla):
        assert o.shape == (b, *jcfg.out_size, img4.shape[-1]) and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(p), atol=ATOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(x), atol=ATOL)
    if name == "flip":
        # full-image crop: flipped output is the mirror of the unflipped one
        noflip = params.copy()
        noflip[:, [4, 4 + fa.PARAMS_PER_VIEW]] = 0.0
        plain, _ = fa.two_view_augment_reference(torch.from_numpy(noflip), torch.from_numpy(images),
                                                 tcfg.out_size, mean, std, dtype=torch.float32)
        np.testing.assert_allclose(ours[0].numpy(), plain.numpy()[:, :, ::-1], atol=ATOL)


def test_fused_crop_touching_right_and_bottom_edge():
    """y0 + ch = H and x0 + cw = W: the last output pixel's high tap would
    be row/column H (out of range); it must carry weight 0, not wrap."""
    rng = np.random.default_rng(7)
    b, h, w = 3, 40, 56
    images = rng.integers(0, 256, size=(b, h, w, 1)).astype(np.uint8)
    params = np.zeros((b, fa.N_PARAMS), np.float32)
    for v in range(2):
        o = v * fa.PARAMS_PER_VIEW
        ch = np.array([40.0, 17.5, 8.25], np.float32)
        cw = np.array([56.0, 30.5, 3.0], np.float32)
        params[:, o + 0], params[:, o + 1] = h - ch, w - cw
        params[:, o + 2], params[:, o + 3] = ch, cw
        params[:, o + 4] = v  # view 2 flipped
        params[:, o + 9], params[:, o + 10] = 128.0, 255.0
    mean, std = (57.9764,), (60.4759,)
    ours = fa.two_view_augment_reference(torch.from_numpy(params), torch.from_numpy(images), (24, 24),
                                         mean, std, dtype=torch.float32)
    xla = _reference_views(jnp.asarray(params), jnp.asarray(images), (24, 24), mean, std)
    for o, x in zip(ours, xla):
        assert torch.isfinite(o).all()
        np.testing.assert_allclose(o.numpy(), np.asarray(x), atol=ATOL)


def test_fused_refuses_two_channels_and_unsupported_configs():
    cfg = dataclasses.replace(taug.BYOL_VIEW1, out_size=(16, 16))
    with pytest.raises(ValueError, match="1 or 3 channels"):
        fa.fused_two_view_augment(torch.zeros(2, 32, 32, 2, dtype=torch.uint8), cfg, cfg, (0.0, 0.0),
                                  (1.0, 1.0), generator=torch.Generator().manual_seed(0))
    blur = dataclasses.replace(cfg, blur_prob=1.0)
    with pytest.raises(ValueError, match="does not implement"):
        fa.fused_two_view_augment(torch.zeros(2, 32, 32, 1, dtype=torch.uint8), blur, blur,
                                  generator=torch.Generator().manual_seed(0))


# -------------------------------------------------- sampler distributions


def test_torch_sampler_distributions():
    """n = 20,000 draws per view. Rates are held to their nominal values,
    and the crop's area and aspect to the JAX sampler's, within 5 standard
    errors (a false failure about once in 3.5 million runs per check)."""
    n, h, w = 20_000, 256, 256
    cfg1 = dataclasses.replace(taug.BYOL_VIEW1, window_prob=0.3)
    cfg2 = dataclasses.replace(taug.BYOL_VIEW2, window_prob=0.3, grayscale_prob=0.2)
    ours = fa.sample_view_params(torch.Generator().manual_seed(0), n, h, w, cfg1, cfg2).numpy()
    jcfg1, jcfg2 = (dataclasses.replace(getattr(jaug, nm), window_prob=0.3, grayscale_prob=0.2)
                    for nm in ("BYOL_VIEW1", "BYOL_VIEW2"))
    ref = np.array(jax_sample_view_params(jax.random.key(0), n, h, w, jcfg1, jcfg2))
    assert ours.shape == (n, fa.N_PARAMS) and ours.dtype == np.float32
    assert not ours[:, 2 * fa.PARAMS_PER_VIEW:].any()

    def close(a, b, what):
        se = np.sqrt(a.var() / len(a) + b.var() / len(b))
        assert abs(a.mean() - b.mean()) <= 5 * se + 1e-9, (what, a.mean(), b.mean(), se)

    def rate(x, p, what):
        se = np.sqrt(max(p * (1 - p), 1e-12) / len(x))
        assert abs(x.mean() - p) <= 5 * se, (what, x.mean(), p)

    for v, cfg in enumerate((cfg1, cfg2)):
        y0, x0, ch, cw, flip, sol, thr, gray, win, level, width = ours[:, v * 11:(v + 1) * 11].T
        r = ref[:, v * 11:(v + 1) * 11].T
        assert (ch >= 1).all() and (ch <= h).all() and (cw >= 1).all() and (cw <= w).all()
        assert (y0 >= 0).all() and (y0 + ch <= h + 1e-3).all() and (x0 + cw <= w + 1e-3).all()
        close(ch * cw / (h * w), r[2] * r[3] / (h * w), "area")
        close(np.log(cw / ch), np.log(r[3] / r[2]), "log aspect")
        close(y0 / (h - ch + 1e-6), r[0] / (h - r[2] + 1e-6), "y0 offset")
        rate(flip, cfg.hflip_prob, "flip")
        rate(sol, cfg.solarize_prob, "solarize")
        rate(gray, cfg.grayscale_prob, "grayscale")
        rate(win, cfg.window_prob, "window")
        assert (thr == cfg.solarize_threshold).all()
        lo, hi = cfg.window_level_range
        assert (level >= lo).all() and (level <= hi).all()
        rate((level - lo) / (hi - lo) < 0.5, 0.5, "level midpoint")
        lo, hi = cfg.window_width_range
        assert (width >= lo).all() and (width <= hi).all()


# ----------------------------------------------- plain path vs JAX's


def _jax_view_draws(key, b, h, w, c, cfg):
    """The draws JAX's ``augment_view`` makes from ``key``, keyed the way
    ``sample_view_draws`` names them (``ops/augment.py:200-275``)."""
    keys = jax.random.split(key, 8)
    u = lambda k, lo=0.0, hi=1.0: np.asarray(jax.random.uniform(k, (b, 1, 1, 1), minval=lo, maxval=hi)).reshape(b)
    d = dict(zip(("y0", "x0", "h", "w"),
                 (np.asarray(a) for a in jaug.sample_rrc_window(keys[0], b, h, w, cfg.crop_scale, cfg.crop_ratio))))
    d["flip"] = np.asarray(jax.random.uniform(keys[1], (b,))) < cfg.hflip_prob
    if cfg.blur_prob > 0.0:
        for axis, k in (("y", keys[2]), ("x", keys[3])):
            r_sig, r_coin = jax.random.split(k)
            d[f"blur_sigma_{axis}"] = np.asarray(jax.random.uniform(r_sig, (b,), minval=0.1, maxval=2.0))
            d[f"blur_coin_{axis}"] = np.asarray(jax.random.uniform(r_coin, (b,))) < cfg.blur_prob
    if cfg.jitter_prob > 0.0:
        jk = jax.random.split(keys[4], 4)
        d["jitter_on"] = (u(jk[0]) < cfg.jitter_prob).astype(np.float32)
        for name, k in zip(("brightness", "contrast", "saturation"), jk[1:]):
            amount = getattr(cfg, name)
            if amount > 0 and (name != "saturation" or c == 3):
                d[name] = u(k, 1 - amount, 1 + amount)
    if cfg.grayscale_prob > 0.0 and c == 3:
        d["gray"] = u(keys[5]) < cfg.grayscale_prob
    if cfg.window_prob > 0.0:
        wk = jax.random.split(keys[7], 3)
        d["window_on"] = u(wk[0]) < cfg.window_prob
        d["level"] = u(wk[1], *cfg.window_level_range)
        d["width"] = u(wk[2], *cfg.window_width_range)
    if cfg.solarize_prob > 0.0:
        d["solarize"] = u(keys[6]) < cfg.solarize_prob
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


# (recipe, channels, extra changes, image size)
PLAIN_CASES = [
    ("BYOL_TV", 3, {}, 40),
    ("BYOL_TV", 1, {}, 48),
    ("BYOL", 1, {"window_prob": 0.6}, 48),
    ("BYOL", 3, {"grayscale_prob": 0.5}, 40),
]


@pytest.mark.parametrize("recipe,channels,changes,size", PLAIN_CASES)
def test_plain_two_view_augment_matches_jax(recipe, channels, changes, size):
    b = 6
    images = np.random.default_rng(size + channels).integers(0, 256, size=(b, size, size, channels)).astype(np.uint8)
    mean, std = (60.0,) * channels, (50.0,) * channels
    jc1, tc1 = _cfgs(f"{recipe}_VIEW1", out_size=(24, 24), **changes)
    jc2, tc2 = _cfgs(f"{recipe}_VIEW2", out_size=(24, 24), **changes)
    key = jax.random.key(size)
    j1, j2 = jaug.two_view_augment(key, jnp.asarray(images), jc1, jc2, mean=mean, std=std, dtype=jnp.float32)
    k1, k2 = jax.random.split(key)
    timg = torch.from_numpy(images)
    for kv, jcfg, tcfg, want in ((k1, jc1, tc1, j1), (k2, jc2, tc2, j2)):
        draws = _jax_view_draws(kv, b, size, size, channels, jcfg)
        got = taug.apply_view(draws, timg, tcfg, mean, std, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plain_two_view_augment_draws_from_generator():
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, size=(4, 32, 32, 1)).astype(np.uint8))
    cfg = dataclasses.replace(taug.BYOL_TV_VIEW1, out_size=(16, 16))
    a = taug.two_view_augment(torch.Generator().manual_seed(3), images, cfg, cfg)
    b = taug.two_view_augment(torch.Generator().manual_seed(3), images, cfg, cfg)
    for x, y in zip(a, b):
        assert x.shape == (4, 16, 16, 1) and x.dtype == torch.bfloat16
        assert torch.isfinite(x.float()).all() and torch.equal(x, y)
    assert not torch.equal(a[0], a[1])
