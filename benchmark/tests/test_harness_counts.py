"""Operations and bytes from the configuration's shapes, against hand counts."""

import json
import os

import pytest
import torch

from benchmark.harness import counts, spec
from benchmark.reference.augment import N_PARAMS, PARAMS_PER_VIEW, sample_view_params, view_configs


def _cfg(name):
    with open(os.path.join(spec.BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


def _out(size, k, s, p):
    return (size + 2 * p - k) // s + 1


def resnet18_macs(size: int, cin: int = 1) -> int:
    """Multiply-accumulates of the ResNet-18 forward, layer by layer."""
    h = _out(size, 7, 2, 3)
    macs = 7 * 7 * cin * 64 * h * h
    h = _out(h, 3, 2, 1)
    c = 64
    for stage, f in enumerate((64, 128, 256, 512)):
        for block in range(2):
            s = 2 if stage > 0 and block == 0 else 1
            ho = _out(h, 3, s, 1)
            macs += 9 * c * f * ho * ho + 9 * f * f * ho * ho
            if s != 1 or c != f:
                macs += c * f * ho * ho
            h, c = ho, f
    return macs


def unet_decoder_macs(size: int) -> int:
    macs, cin = 0, 512
    for i, (f, skip) in enumerate(zip((256, 128, 64, 32, 16), (256, 128, 64, 64, 0))):
        h = size // 2 ** (4 - i)
        macs += 9 * (cin + skip) * f * h * h + 9 * f * f * h * h
        cin = f
    return macs + 9 * 16 * 1 * size * size


def test_resnet18_at_112_is_the_hand_count():
    stem = 7 * 7 * 64 * 56 * 56
    layer1 = 4 * 9 * 64 * 64 * 28 * 28
    layer2 = (9 * 64 * 128 + 3 * 9 * 128 * 128 + 64 * 128) * 14 * 14
    layer3 = (9 * 128 * 256 + 3 * 9 * 256 * 256 + 128 * 256) * 7 * 7
    layer4 = (9 * 256 * 512 + 3 * 9 * 512 * 512 + 256 * 512) * 4 * 4
    assert resnet18_macs(112) == stem + layer1 + layer2 + layer3 + layer4 == 465_178_624


def test_byol_step_flops_match_the_hand_count():
    cfg = _cfg("byol_r18")
    b = 16
    enc = resnet18_macs(cfg["crop_size"])
    heads = 512 * 4096 + 4096 * 256
    pred = 256 * 4096 + 4096 * 256
    online_fwd = 2 * b * (enc + heads + pred)
    target_fwd = 2 * b * (enc + heads)
    # backward: weight and input gradients, but no input gradient for the stem
    stem = 7 * 7 * 1 * 64 * 56 * 56
    backward = 2 * online_fwd - 2 * b * stem
    assert counts.byol_step_flops(cfg, b) == pytest.approx(2 * (online_fwd + target_fwd + backward), rel=1e-9)


def test_unet_forward_flops_match_the_hand_count():
    cfg = _cfg("unet_r18")
    hand = resnet18_macs(224) + unet_decoder_macs(224)
    assert counts.unet_forward_flops(cfg, 3) == pytest.approx(3 * 2 * hand, rel=1e-9)
    assert 8.0e9 < 2 * hand < 8.3e9


def _params(b, y0, x0, h, w, flip=0.0):
    p = torch.zeros(b, N_PARAMS)
    for v in range(2):
        p[:, v * PARAMS_PER_VIEW:v * PARAMS_PER_VIEW + 5] = torch.tensor([y0, x0, h, w, flip])
    return p


def test_kernel_bytes_of_whole_crops_at_full_size_are_the_whole_images():
    views_and_params = 2 * 4 * 256 * 256 * 2 + 4 * N_PARAMS * 4
    assert counts.two_view_augment_bytes(_params(4, 0, 0, 256, 256), (4, 256, 256, 1), (256, 256)) \
        == 4 * 256 * 256 + views_and_params


def test_kernel_bytes_by_hand():
    # a 16×16 window at (40, 40) sampled to 8×8: taps read rows and columns
    # 40..55, one 32-byte sector (columns 32..63) of each of 16 rows
    assert counts.two_view_augment_bytes(_params(3, 40, 40, 16, 16, 1.0), (3, 256, 256, 1), (8, 8)) \
        == 3 * (16 * 32 + 2 * 8 * 8 * 2 + N_PARAMS * 4)


def test_kernel_bytes_agree_with_the_programs_count():
    from medical_image_segmentation_tpu_torch.ops.fused_augment import touched_input_bytes

    cfg = _cfg("byol_r18")
    c1, c2 = view_configs(cfg)
    params = sample_view_params(torch.Generator().manual_seed(7), 64, 256, 256, c1, c2)
    views_and_params = 2 * 64 * 112 * 112 * 2 + 64 * N_PARAMS * 4
    assert counts.two_view_augment_bytes(params, (64, 256, 256, 1), (112, 112)) \
        == touched_input_bytes(params, (64, 256, 256, 1), 1, (112, 112)) + views_and_params
