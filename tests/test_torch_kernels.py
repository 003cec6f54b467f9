"""The port's hand-written CUDA kernels against their plain PyTorch
versions, and the wrappers' rules.

This file imports no JAX, so that it also runs on a machine with a card
and without JAX: ``python -m pytest --noconftest tests/test_torch_kernels.py -q``
(``--noconftest``: the suite's ``conftest.py`` configures JAX). Tests that
need the card are marked ``gpu`` and skip without one.
"""

import ctypes
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu_torch.ops import _kernels
from medical_image_segmentation_tpu_torch.ops import augment as taug
from medical_image_segmentation_tpu_torch.ops import fused_augment as fa
from medical_image_segmentation_tpu_torch.ops import global_batchnorm as gbn

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _cfg(vmax: float, out=(40, 40)):
    return dataclasses.replace(taug.BYOL_VIEW2, out_size=out, window_prob=0.5, grayscale_prob=0.5,
                               solarize_prob=0.5, value_max=vmax, solarize_threshold=vmax / 2,
                               window_level_range=(0.4 * vmax, 0.6 * vmax), window_width_range=(0.5 * vmax, vmax))


def _bf16_ulps(a, b) -> int:
    """Largest distance between two bf16 tensors in units in the last
    place: sign-magnitude bit patterns mapped onto a monotone integer line."""

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i + 32768))

    return int((ordered(a) - ordered(b)).abs().max())


def test_bf16_ulp_distance():
    one = torch.tensor([1.0, -1.0, 0.0], dtype=torch.bfloat16)
    nxt = torch.tensor([1.0078125, -1.0078125, 0.0], dtype=torch.bfloat16)  # 1 + 2**-7: one ulp up
    assert _bf16_ulps(one, one) == 0 and _bf16_ulps(one, nxt) == 1
    assert _bf16_ulps(torch.tensor([-0.0], dtype=torch.bfloat16), torch.tensor([0.0], dtype=torch.bfloat16)) == 0


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    images = torch.randint(0, 256, (3, 24, 32, 1), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    cfg = _cfg(255.0, (16, 16))
    params = fa.sample_view_params(torch.Generator().manual_seed(1), 3, 24, 32, cfg, cfg)
    before = fa.fused_two_view_augment.launches
    got = fa.fused_two_view_augment(images, cfg, cfg, (100.0,), (50.0,), torch.float32, params=params)
    want = fa.two_view_augment_reference(params, images, cfg.out_size, (100.0,), (50.0,), 255.0, torch.float32)
    assert fa.fused_two_view_augment.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_build_raises_without_a_toolkit_and_never_falls_back(monkeypatch, tmp_path):
    def no_toolkit():
        raise RuntimeError("no CUDA toolkit")

    monkeypatch.setattr(_kernels, "_nvcc", no_toolkit)
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA toolkit"):
        _kernels.build_kernel("two_view_augment")


@pytest.mark.gpu
@pytest.mark.parametrize("channels,in_dtype", [(1, torch.uint8), (3, torch.uint8), (1, torch.uint16)])
def test_kernel_matches_plain_version_on_card(cuda, channels, in_dtype):
    """Same params, same inputs: f32 outputs within 1e-5, bf16 within one
    unit in the last place (both round the same f32 value once)."""
    vmax = 255.0 if in_dtype == torch.uint8 else 65535.0
    cfg = _cfg(vmax)
    gen = torch.Generator(device=cuda).manual_seed(0)
    images = torch.randint(0, int(vmax) + 1, (16, 72, 88, channels), generator=gen, device=cuda,
                           dtype=torch.int64).to(in_dtype)
    params = fa.sample_view_params(gen, 16, 72, 88, cfg, cfg)
    mean, std = (0.4 * vmax,) * channels, (0.2 * vmax,) * channels
    for dtype in (torch.float32, torch.bfloat16):
        before = fa.fused_two_view_augment.launches
        got = fa.fused_two_view_augment(images, cfg, cfg, mean, std, dtype, params=params)
        assert fa.fused_two_view_augment.launches == before + 1
        want = fa.two_view_augment_reference(params, images, cfg.out_size, mean, std, vmax, dtype)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == (16, 40, 40, channels) and g.dtype == dtype and g.is_contiguous()
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
            else:
                assert _bf16_ulps(g, w) <= 1


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    cfg = _cfg(255.0, (8, 8))
    images = torch.zeros(2, 16, 16, 1, dtype=torch.int32, device=cuda)
    params = torch.zeros(2, fa.N_PARAMS, device=cuda)
    with pytest.raises(TypeError, match="uint8 or uint16"):
        fa.fused_two_view_augment(images, cfg, cfg, params=params)
    with pytest.raises(ValueError, match="params must be"):
        fa.fused_two_view_augment(images.to(torch.uint8), cfg, cfg, params=params[:, :11].contiguous())
    with pytest.raises(ValueError, match="CUDA device"):
        fa.fused_two_view_augment(images.to(torch.uint8), cfg, cfg, params=params.cpu())


def _brute_force_touched_bytes(params, in_shape, elem_size, out_size, sector=32):
    """Sector count by walking every output pixel's four taps, with the
    taps computed in numpy float32, one rounding per operation."""
    f32 = np.float32
    b, h, w, c = in_shape
    oh, ow = out_size
    p = params.numpy()
    sectors = set()

    def taps(start, size, n_in, n_out, i, mirror):
        pos = f32(i) + f32(0.5)
        if mirror:
            pos = f32(n_out) - pos
        src = f32(f32(start + pos * f32(f32(size) / f32(n_out))) - f32(0.5))
        lo = int(np.floor(min(max(src, f32(0)), f32(n_in - 1))))
        return lo, min(lo + 1, n_in - 1)

    for i in range(b):
        for v in range(2):
            y0, x0, ch, cw, flip = p[i, 11 * v:11 * v + 5]
            for oy in range(oh):
                for ox in range(ow):
                    for r in taps(y0, ch, h, oh, oy, False):
                        for x in taps(x0, cw, w, ow, ox, flip > 0.5):
                            start = ((i * h + r) * w + x) * c * elem_size
                            sectors.update(range(start // sector, (start + c * elem_size - 1) // sector + 1))
    return len(sectors) * sector


@pytest.mark.parametrize("channels,elem_size,seed", [(1, 1, 0), (3, 1, 1), (1, 2, 2), (1, 1, 3)])
def test_touched_input_bytes_match_a_brute_force_count(channels, elem_size, seed):
    cfg = _cfg(255.0, (9, 7))
    shape = (3, 40, 36, channels)
    params = fa.sample_view_params(torch.Generator().manual_seed(seed), 3, 40, 36, cfg, cfg)
    if seed == 3:  # crops on the right and bottom edges, flipped
        for v in range(2):
            params[:, 11 * v] = 40 - params[:, 11 * v + 2]
            params[:, 11 * v + 1] = 36 - params[:, 11 * v + 3]
            params[:, 11 * v + 4] = 1.0
    got = fa.touched_input_bytes(params, shape, elem_size, (9, 7))
    assert got == _brute_force_touched_bytes(params, shape, elem_size, (9, 7))
    assert 0 < got <= 3 * 40 * 36 * channels * elem_size + 32


def _check_on_card(images, cfg1, cfg2, mean, std, params):
    """The kernel against the plain version on the same parameters, for
    both output types: f32 within 1e-5, bf16 within one unit in the last
    place; one launch each."""
    b, h, w, c = images.shape
    for dtype in (torch.float32, torch.bfloat16):
        before = fa.fused_two_view_augment.launches
        got = fa.fused_two_view_augment(images, cfg1, cfg2, mean, std, dtype, params=params)
        assert fa.fused_two_view_augment.launches == before + 1
        want = fa.two_view_augment_reference(params, images, cfg1.out_size, mean, std, cfg1.value_max, dtype)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            assert g.shape == (b, *cfg1.out_size, c) and g.dtype == dtype and g.is_contiguous()
            assert bool(torch.isfinite(g.float()).all())
            if dtype == torch.float32:
                torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
            else:
                assert _bf16_ulps(g, r) <= 1


def _images(cuda, shape, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    hi = 256 if dtype == torch.uint8 else 65536
    return torch.randint(0, hi, shape, generator=gen, device=cuda, dtype=torch.int64).to(dtype)


def _params(cuda, b, h, w, cfg1, cfg2, seed=1):
    return fa.sample_view_params(torch.Generator(device=cuda).manual_seed(seed), b, h, w, cfg1, cfg2)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 257])
def test_kernel_batch_sizes_on_card(cuda, batch):
    cfg = dataclasses.replace(taug.BYOL_VIEW2, out_size=(112, 112))
    images = _images(cuda, (batch, 256, 256, 1), torch.uint8)
    _check_on_card(images, cfg, cfg, (58.0,), (60.5,), _params(cuda, batch, 256, 256, cfg, cfg))


@pytest.mark.gpu
@pytest.mark.parametrize("ow", [32, 100, 112, 224])
def test_kernel_output_widths_on_card(cuda, ow):
    """Widths whose rows are and are not whole 16-byte chunks, ragged band
    edges included (100 = 12.5 chunks of bf16, 25 of f32)."""
    cfg = _cfg(255.0, (ow // 2 + 3, ow))
    images = _images(cuda, (9, 96, 128, 1), torch.uint8)
    _check_on_card(images, cfg, cfg, (100.0,), (50.0,), _params(cuda, 9, 96, 128, cfg, cfg))


@pytest.mark.gpu
def test_kernel_crops_on_the_right_and_bottom_edges_on_card(cuda):
    cfg = _cfg(255.0, (56, 56))
    images = _images(cuda, (12, 128, 96, 1), torch.uint8)
    params = _params(cuda, 12, 128, 96, cfg, cfg)
    for v in range(2):
        params[:, 11 * v] = 128 - params[:, 11 * v + 2]
        params[:, 11 * v + 1] = 96 - params[:, 11 * v + 3]
    _check_on_card(images, cfg, cfg, (100.0,), (50.0,), params)


@pytest.mark.gpu
def test_kernel_forced_flip_and_solarize_on_card(cuda):
    cfg = dataclasses.replace(_cfg(255.0, (112, 112)), hflip_prob=1.0, solarize_prob=1.0)
    images = _images(cuda, (32, 256, 256, 1), torch.uint8)
    params = _params(cuda, 32, 256, 256, cfg, cfg)
    assert bool((params[:, [4, 5, 15, 16]] == 1.0).all())
    _check_on_card(images, cfg, cfg, (100.0,), (50.0,), params)


@pytest.mark.gpu
def test_kernel_uint16_with_a_window_on_card(cuda):
    cfg = dataclasses.replace(_cfg(65535.0, (112, 112)), window_prob=1.0)
    images = _images(cuda, (32, 256, 256, 1), torch.uint16)
    params = _params(cuda, 32, 256, 256, cfg, cfg)
    assert bool((params[:, [8, 19]] == 1.0).all())
    _check_on_card(images, cfg, cfg, (26214.0,), (13107.0,), params)


@pytest.mark.gpu
def test_kernel_rgb_with_grayscale_on_card(cuda):
    cfg = dataclasses.replace(_cfg(255.0, (112, 112)), grayscale_prob=1.0)
    images = _images(cuda, (16, 224, 224, 3), torch.uint8)
    params = _params(cuda, 16, 224, 224, cfg, cfg)
    _check_on_card(images, cfg, cfg, (124.0, 116.0, 104.0), (58.0, 57.0, 57.5), params)


@pytest.mark.gpu
def test_kernel_banded_staging_on_card(cuda):
    """uint16 1024² rows are 2 KB: a block stages only a few output rows'
    source rows at a time, so each sample takes many bands."""
    plan = fa.kernel_plan(1024, 1024, 1, (112, 112), torch.uint16)
    assert plan["n_bands"] >= 8 and plan["rows_cap"] < 1024 and plan["smem_bytes"] <= 227 * 1024
    cfg = _cfg(65535.0, (112, 112))
    images = _images(cuda, (6, 1024, 1024, 1), torch.uint16)
    _check_on_card(images, cfg, cfg, (26214.0,), (13107.0,), _params(cuda, 6, 1024, 1024, cfg, cfg))


@pytest.mark.gpu
def test_kernel_parameters_beyond_the_sampler_on_card(cuda):
    """Crops larger than the image and partly outside it take source rows
    beyond the staged ones, which the kernel reads from device memory."""
    cfg = _cfg(255.0, (64, 48))
    images = _images(cuda, (8, 80, 72, 1), torch.uint8)
    params = _params(cuda, 8, 80, 72, cfg, cfg)
    rng = torch.Generator(device=cuda).manual_seed(5)
    for v in range(2):
        params[:, 11 * v] = torch.rand(8, generator=rng, device=cuda) * 160 - 80
        params[:, 11 * v + 2] = torch.rand(8, generator=rng, device=cuda) * 240 + 1
    _check_on_card(images, cfg, cfg, (100.0,), (50.0,), params)


@pytest.mark.gpu
def test_kernel_plan_of_the_main_shape_and_refusals(cuda):
    plan = fa.kernel_plan(256, 256, 1, (112, 112))
    assert plan["n_bands"] >= 2 and plan["band"] * plan["n_bands"] >= 112
    assert plan["rows_cap"] >= (plan["band"] - 1) * 256 // 112 + 3
    with pytest.raises(ValueError, match="cannot plan"):  # an output row of more than 2**30 values
        fa.kernel_plan(64, 64, 3, (16, 1 << 29))
    images = _images(cuda, (4, 64, 64, 1), torch.uint8)
    cfg = _cfg(255.0, (16, 16))
    params = _params(cuda, 4, 64, 64, cfg, cfg)
    view = torch.zeros(4 * 64 * 64 + 1, dtype=torch.uint8, device=cuda)[1:].view(4, 64, 64, 1)
    view.copy_(images)
    assert view.data_ptr() % 16 != 0
    _check_on_card(view, cfg, cfg, (100.0,), (50.0,), params)


@pytest.mark.gpu
def test_fused_window_predictor_replays_its_graph_equal_to_the_loop(cuda):
    """No hand-written kernel, but card-only all the same: on the CPU the
    fused predictor never captures (``tests/test_torch_fused_window.py``
    holds it eagerly there, against JAX)."""
    from medical_image_segmentation_tpu_torch.eval import sliding_window as tsw

    conv = torch.nn.Conv2d(1, 1, 3, padding=1).to(cuda)

    def fn(w):
        return conv(w.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    fused = tsw.make_fused_predictor_2d(fn, (70, 53, 1), 32, device=cuda)
    for seed in (0, 1, 2):  # eager (the warm-up), capture + replay, replay
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal((70, 53, 1)).astype(np.float32)).to(cuda)
        with torch.no_grad():
            want = tsw.sliding_window_predict(fn, x, 32)
        got = fused(x)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert fused.replays == 2 and fused.capture_seconds > 0


def _c_signatures(path: str) -> dict:
    """The ``extern "C"`` functions of a CUDA source as ctypes signatures:
    name -> (restype, argtypes), every pointer a c_void_p."""
    with open(path) as f:
        text = f.read()
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    out = {}
    for ret, name, params in re.findall(r'extern "C" (\w+) (\w+)\(([^)]*)\)', text):
        args = []
        for p in params.split(","):
            p = " ".join(p.split())
            args.append(ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0].removeprefix("const ")])
        out[name] = (kinds[ret], args)
    return out


@pytest.mark.parametrize("name", sorted(_kernels.SIGNATURES))
def test_signatures_match_the_sources_extern_c_declarations(name):
    assert _c_signatures(os.path.join(_kernels.CSRC_DIR, f"{name}.cu")) == {
        fn: (res, list(args)) for fn, (res, args) in _kernels.SIGNATURES[name].items()}


# global BatchNorm's (N, C, ...) inputs as the data-parallel trainers hand them over
_BN_LAYOUTS = {"2d": ((1037,), torch.contiguous_format), "4d": ((3, 7, 11), torch.channels_last),
               "5d": ((3, 3, 5, 7), torch.channels_last_3d)}


def _bn_input(layout: str, c: int, dtype, device="cpu", seed=0):
    """A seeded (N, C, ...) activation in ``layout`` with a mean and scale
    of its own per channel, as a convolution's output has."""
    dims, fmt = _BN_LAYOUTS[layout]
    shape = (dims[0], c, *dims[1:])
    gen = torch.Generator().manual_seed(seed)
    view = (1, c) + (1,) * (len(shape) - 2)
    x = torch.randn(shape, generator=gen) * (0.5 + torch.rand(view, generator=gen)) + torch.randn(view, generator=gen)
    return x.to(device=device, dtype=dtype).contiguous(memory_format=fmt)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", sorted(_BN_LAYOUTS))
def test_global_batchnorm_cpu_tensors_take_the_plain_version(layout, dtype):
    x, dy = _bn_input(layout, 24, dtype), _bn_input(layout, 24, dtype, seed=1)
    w, b = torch.rand(24) + 0.5, torch.randn(24)
    before = gbn.launches
    stats = gbn.batch_stats(x)
    assert torch.equal(stats, gbn.stats_reference(x)) and stats[-1] == x.numel() // 24
    rm, rv = torch.zeros(24), torch.ones(24)
    y, mean, invstd = gbn.normalize(x, w, b, stats, 1e-5, 0.9, (rm, rv))
    want_mean, want_var, want_invstd = gbn.moments_reference(stats, 1e-5)
    assert torch.equal(mean, want_mean) and torch.equal(invstd, want_invstd)
    assert torch.equal(rm, 0.1 * want_mean) and torch.allclose(rv, 0.9 + 0.1 * want_var)
    assert torch.equal(y, gbn.normalize_reference(x, w, b, mean, invstd)) and y.dtype == dtype
    sums, grad_w, grad_b = gbn.backward_reduce(x, dy, mean, invstd)
    assert torch.equal(sums, gbn.backward_reduce_reference(x, dy, mean, invstd))
    assert torch.equal(grad_b, sums[:24]) and torch.equal(grad_w, sums[24:])
    dx = gbn.backward_elemt(x, dy, w, mean, invstd, sums, stats[-1:])
    assert torch.equal(dx, gbn.backward_elemt_reference(x, dy, w, mean, invstd, sums, stats[-1:]))
    assert gbn.launches == before


@pytest.mark.parametrize("shape, fmt, dtype, error", [
    ((2, 8, 3, 3), torch.contiguous_format, torch.bfloat16, ValueError),  # NCHW
    ((2, 8, 3, 3, 3), torch.contiguous_format, torch.float32, ValueError),  # NCDHW
    ((2, 8, 5), torch.contiguous_format, torch.float32, ValueError),  # (N, C, L)
    ((4, 8), torch.contiguous_format, torch.float16, TypeError),
    ((4, 8), torch.contiguous_format, torch.float64, TypeError),
    ((0, 8, 3, 3), torch.channels_last, torch.bfloat16, ValueError),
])
def test_global_batchnorm_kernels_refuse_what_they_do_not_take(shape, fmt, dtype, error):
    x = torch.zeros(shape, dtype=dtype).contiguous(memory_format=fmt)
    with pytest.raises(error):
        gbn.kernel_layout(x)


def test_global_batchnorm_kernels_take_transposes_only_when_contiguous():
    assert gbn.kernel_layout(torch.zeros(4, 8)) == torch.contiguous_format
    with pytest.raises(ValueError, match="contiguous 2-D"):
        gbn.kernel_layout(torch.zeros(8, 4).t())
    assert gbn.kernel_layout(torch.zeros(2, 8, 3, 3).contiguous(memory_format=torch.channels_last)) == \
        torch.channels_last


def test_global_batchnorm_counts_launches_and_under_a_profiler_the_counter():
    from torch.profiler import ProfilerActivity, profile

    from medical_image_segmentation_tpu_torch.core import profiling

    before = gbn.launches
    profiling.reset_counters()
    gbn._launched(0, "stats", 2)
    assert gbn.launches == before + 2 and "bn.global_kernels" not in profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        gbn._launched(0, "normalize", 1)
        gbn._launched(0, "backward reduce", 2)
    assert gbn.launches == before + 5 and profiling.counters()["bn.global_kernels"] == 3
    with pytest.raises(RuntimeError, match="backward elemt launch failed: CUDA error 1"):
        gbn._launched(1, "backward elemt", 1)
    assert gbn.launches == before + 5
    profiling.reset_counters()


def test_global_batchnorm_has_no_version_for_other_devices():
    with pytest.raises(RuntimeError, match="no global BatchNorm implementation"):
        gbn.batch_stats(torch.zeros(4, 8, device="meta"))


def _chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("mode, forwards, backwards, local", [
    ("global", 2, 2, 0), ("global_no_grad", 2, 0, 0), ("local", 0, 0, 2), ("eval", 0, 0, 0),
    ("local_kernels", 0, 0, 2), ("local_kernels_no_grad", 0, 0, 2)])
def test_the_smoke_counts_batchnorm_calls_at_the_module_boundary(monkeypatch, mode, forwards, backwards, local):
    """Global forwards, the backwards that reach them and local calls in
    training, and of the local ones those whose input the one-card kernels
    take, with their backwards; eval calls are none of these. On the CPU
    both kernel paths run the plain versions, which launch nothing."""
    from medical_image_segmentation_tpu_torch.models import batchnorm

    smoke = _chip_smoke(monkeypatch)
    monkeypatch.setattr(batchnorm, "all_reduce_", lambda t, group: t)  # a group of one rank
    if mode.startswith("local_kernels"):
        monkeypatch.setattr(gbn, "takes", lambda x: True)
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), batchnorm.BatchNorm(8), torch.nn.ReLU(), batchnorm.BatchNorm(8))
    for m in net:
        if isinstance(m, batchnorm.BatchNorm) and mode.startswith("global"):
            m.group = "ranks"
    net.train(mode != "eval")
    calls = smoke.BatchNormCalls(torch)
    try:
        with torch.set_grad_enabled(not mode.endswith("no_grad")):
            y = net(torch.randn(16, 4))
        if y.requires_grad:
            y.square().sum().backward()
        assert calls.take() == {"launches": 0, "forwards": forwards, "backwards": backwards, "local": local,
                                "local_launches": 0, "local_forwards": local if mode.startswith("local_kernels") else 0,
                                "local_backwards": local if mode == "local_kernels" else 0,
                                "local_library": 0}  # CPU inputs
        assert set(calls.take().values()) == {0}
    finally:
        calls.handle.remove()


_BN_COUNTS = ("launches", "forwards", "backwards", "local", "local_launches", "local_forwards", "local_backwards",
              "local_library")


@pytest.mark.parametrize("counts, global_path, error", [
    ((12, 2, 2, 0, 0, 0, 0, 0), True, None),
    ((9, 2, 2, 0, 0, 0, 0, 0), True, r"launched 9 kernels, not 3 × \(2 forwards \+ 2 backwards\) = 12"),
    ((0, 0, 0, 3, 0, 0, 0, 0), True, "3 BatchNorm calls kept their local statistics"),
    ((0, 0, 0, 3, 0, 0, 0, 3), False, None),
    ((6, 1, 1, 0, 0, 0, 0, 0), False, "1 BatchNorm calls took the global path"),
    ((0, 0, 0, 3, 9, 2, 1, 1), False, None),  # tp's data group of one rank: the one-card kernels
    ((0, 0, 0, 3, 6, 2, 1, 1), False, r"one-card BatchNorm launched 6 kernels, not 3 × \(2 forwards"),
])
def test_the_smoke_holds_each_rank_to_three_kernels_a_global_call(monkeypatch, counts, global_path, error):
    smoke = _chip_smoke(monkeypatch)
    monkeypatch.setattr(smoke, "BN_RANK_LAUNCHES", {})
    counts = dict(zip(_BN_COUNTS, counts))
    if error is None:
        smoke.check_global_bn("dist_seg rank 1", counts, global_path)
        assert smoke.BN_RANK_LAUNCHES == {"dist_seg": [counts["launches"]]}
    else:
        with pytest.raises(smoke.SmokeFailure, match=error):
            smoke.check_global_bn("dist_seg rank 1", counts, global_path)


@pytest.mark.parametrize("counts, error", [
    ((0, 0, 0, 5, 18, 4, 2, 1), None),  # one call on the card left to F.batch_norm
    ((0, 0, 0, 3, 0, 0, 0, 0), None),  # on the CPU
    ((0, 0, 0, 4, 12, 4, 2, 0), r"one-card BatchNorm launched 12 kernels, not 3 × \(4 forwards \+ 2 backwards\) = 18"),
    ((3, 1, 0, 0, 0, 0, 0, 0), "global BatchNorm ran in one process"),
])
def test_the_smoke_holds_one_process_to_three_kernels_a_local_call(monkeypatch, counts, error):
    smoke = _chip_smoke(monkeypatch)
    monkeypatch.setattr(smoke, "BN_LIBRARY_CALLS", {})

    class Calls:
        def take(self):
            return dict(zip(_BN_COUNTS, counts))

    paths = {"one_card": 6}
    if error is None:
        smoke.take_bn_launches(Calls(), paths, "one_card")
        assert paths == {"one_card": 6 + counts[4]}
        assert smoke.BN_LIBRARY_CALLS == {"one_card": counts[7]}
    else:
        with pytest.raises(smoke.SmokeFailure, match=error):
            smoke.take_bn_launches(Calls(), paths, "one_card")


def _f32_ulps(a, b) -> int:
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i >= 0, i, -(i + 2 ** 31))

    return int((ordered(a) - ordered(b)).abs().max())


def _ulps(a, b) -> int:
    return _bf16_ulps(a, b) if a.dtype == torch.bfloat16 else _f32_ulps(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [64, 128, 256, 512, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", sorted(_BN_LAYOUTS))
def test_global_batchnorm_kernels_match_plain_version_on_card(cuda, layout, dtype, c):
    """Each of the four kernels against its plain version on the same inputs.

    - Sums: float32 sums of the same values in another order. Each of the
      two differs from the exact sum by at most 2^-24 times its longest
      chain of additions (under 170 at these sizes) times the sum of the
      terms' magnitudes: within 1e-5 of Σ|v| per channel.
    - Moments from the same sums: mean equal; invstd within 2 float32 ulp
      (CUDA's ``rsqrtf`` is within 2 ulp of the true value).
    - Normalize and dx from the same mean, invstd and sums: within 1 ulp of
      the working dtype (each product and sum rounded as the plain version
      rounds it, once to the dtype at the end).
    - dx from each side's own sums: the sums' difference moves Σdy/n and
      Σdy·x̂/n by 1e-5 of mean |dy| and mean |dy·x̂|, so dx by
      |w·invstd|·(1 + |x̂|)·1e-5·mean |dy|: within 1e-4 of max |dx| beyond
      one rounding to the dtype.
    """
    x, dy = _bn_input(layout, c, dtype, cuda), _bn_input(layout, c, dtype, cuda, seed=1)
    assert (x.numel() // c) % 2 == 1  # blocks span a power of two of rows: where one spans more, the last is ragged
    _hold_batchnorm_kernels_to_plain(x, dy)


# unet_r18.train's two narrowest decoder blocks (512 slices: 224² × 16 and 112² × 32)
_BN_UNET_SHAPES = [(512, 16, 224, 224), (512, 32, 112, 112)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _BN_UNET_SHAPES)
def test_batchnorm_kernels_match_plain_version_at_unet_shapes_on_card(cuda, shape):
    """The same limits as above at 25.7 M and 6.4 M rows of two 16-byte
    columns and of four, bf16 channels-last. The sums' longest chain is
    ~700 additions here, so 1e-5 of Σ|v| holds by the rounding errors'
    random signs (their sum grows as the chain's root), not for any input."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    view = (1, shape[1], 1, 1)
    x = torch.randn(shape, generator=gen, device=cuda) * (0.5 + torch.rand(view, generator=gen, device=cuda))
    x = (x + torch.randn(view, generator=gen, device=cuda)).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    dy = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    _hold_batchnorm_kernels_to_plain(x, dy)


def _hold_batchnorm_kernels_to_plain(x, dy):
    c, dtype, cuda = x.shape[1], x.dtype, x.device
    m = x.numel() // c
    gen = torch.Generator().manual_seed(2)
    w, b = (torch.rand(c, generator=gen) + 0.5).to(cuda), torch.randn(c, generator=gen).to(cuda)
    xf, dims = x.float(), [0, *range(2, x.ndim)]

    before = gbn.launches
    stats = gbn.batch_stats(x)
    want = gbn.stats_reference(x)
    torch.cuda.synchronize()
    assert gbn.launches == before + 2
    scale = torch.cat([xf.abs().sum(dims), xf.square().sum(dims)])
    assert bool(((stats[:-1] - want[:-1]).abs() <= 1e-5 * scale).all()) and stats[-1] == m
    assert torch.equal(gbn.batch_stats(x), stats)  # the same sums on every call

    rm, rv = torch.randn(c, device=cuda), torch.rand(c, device=cuda) + 0.5
    rm0, rv0 = rm.clone(), rv.clone()
    y, mean, invstd = gbn.normalize(x, w, b, stats, 1e-5, 0.9, (rm, rv))
    want_mean, want_var, want_invstd = gbn.moments_reference(stats, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(mean, want_mean) and _f32_ulps(invstd, want_invstd) <= 2
    torch.testing.assert_close(rm, 0.9 * rm0 + 0.1 * want_mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(rv, 0.9 * rv0 + 0.1 * want_var, rtol=1e-6, atol=1e-7)
    assert y.dtype == dtype and y.shape == x.shape and y.stride() == x.stride()
    assert _ulps(y, gbn.normalize_reference(x, w, b, mean, invstd)) <= 1

    sums, grad_w, grad_b = gbn.backward_reduce(x, dy, mean, invstd)
    want_sums = gbn.backward_reduce_reference(x, dy, mean, invstd)
    torch.cuda.synchronize()
    xhat = (xf - mean.view(1, -1, *[1] * (x.ndim - 2))) * invstd.view(1, -1, *[1] * (x.ndim - 2))
    scale = torch.cat([dy.float().abs().sum(dims), (dy.float() * xhat).abs().sum(dims)])
    assert bool(((sums - want_sums).abs() <= 1e-5 * scale).all())
    assert torch.equal(grad_b, sums[:c]) and torch.equal(grad_w, sums[c:])

    n = stats[-1:]
    dx = gbn.backward_elemt(x, dy, w, mean, invstd, sums, n)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dx.stride() == x.stride()
    assert _ulps(dx, gbn.backward_elemt_reference(x, dy, w, mean, invstd, sums, n)) <= 1
    plain = gbn.backward_elemt_reference(x, dy, w, want_mean, want_invstd, want_sums, want[-1:]).float()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    assert bool(((dx.float() - plain).abs() <= ulp * plain.abs() + 1e-4 * plain.abs().max()).all())
    assert gbn.launches == before + 8


@pytest.mark.gpu
def test_global_batchnorm_wrapper_on_card(cuda):
    """Another layout of dy is taken (made channels-last); an NCHW
    activation, a half-precision one and running statistics of another
    size raise; recomputing (no running statistics) leaves them alone."""
    x = _bn_input("4d", 64, torch.bfloat16, cuda)
    dy = _bn_input("4d", 64, torch.bfloat16, cuda, seed=1)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    stats = gbn.batch_stats(x)
    y, mean, invstd = gbn.normalize(x, w, b, stats, 1e-5, 0.9)
    sums, _, _ = gbn.backward_reduce(x, dy.contiguous(), mean, invstd)
    assert torch.equal(sums, gbn.backward_reduce(x, dy, mean, invstd)[0])
    with pytest.raises(ValueError, match="channels_last"):
        gbn.batch_stats(x.contiguous())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        gbn.batch_stats(x.half())
    with pytest.raises(ValueError, match="running_mean"):
        gbn.normalize(x, w, b, stats, 1e-5, 0.9, (torch.zeros(32, device=cuda), torch.ones(64, device=cuda)))
    with pytest.raises(ValueError, match="expected"):
        gbn.backward_reduce(x, dy.float(), mean, invstd)
