"""The port's hand-written CUDA kernels against their plain PyTorch
versions, and the wrappers' rules.

This file imports no JAX, so that it also runs on a machine with a card
and without JAX: ``python -m pytest --noconftest tests/test_torch_kernels.py -q``
(``--noconftest``: the suite's ``conftest.py`` configures JAX). Tests that
need the card are marked ``gpu`` and skip without one.
"""

import dataclasses

import pytest
import torch

from medical_image_segmentation_tpu_torch.ops import _kernels
from medical_image_segmentation_tpu_torch.ops import augment as taug
from medical_image_segmentation_tpu_torch.ops import fused_augment as fa

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
