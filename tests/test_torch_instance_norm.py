"""nnU-Net's InstanceNorm + LeakyReLU (``ops/instance_norm.py``): the plain
passes against the chain they replace (``models/unet3d.py::group_norm`` with
a group a channel, then ``F.leaky_relu``), the autograd function's backward
against autograd of that chain, and the hand-written kernels
(``csrc/instance_norm.cu``) against the plain passes.

This file imports no JAX, so that it also runs on a machine with a card and
without JAX: ``python -m pytest --noconftest tests/test_torch_instance_norm.py -q``.
Tests that need the card are marked ``gpu`` and skip without one.

Tolerances. In float32 both sides differ by the order of their sums and
the form of the affine map (``group_norm`` applies x·scale + shift): 1e-5
of the largest magnitude. In bfloat16 the function rounds once, after
the activation: within one bf16 ulp at each value's magnitude (2^-8 of
it) of the float32 chain, beyond float32 noise of 1e-6 of the largest
magnitude (near 0 that noise is many bf16 ulps). The bfloat16 chain
rounded before its activation too, and 0.01 times a rounded value carries
that rounding on: within two.
The kernels' statistics are float32 sums in another order than torch's
``var_mean``: within 1e-5 of invstd, and of |mean| + std for the mean.
Given the same statistics and sums, y and dx are each product and sum
rounded as the plain version rounds it: within one ulp of the dtype.
"""

import pytest
import torch
import torch.nn.functional as F

from medical_image_segmentation_tpu_torch.core import profiling
from medical_image_segmentation_tpu_torch.models.plain_unet3d import InstanceNorm3D, PlainConvUNet3D
from medical_image_segmentation_tpu_torch.models.unet3d import group_norm
from medical_image_segmentation_tpu_torch.ops import instance_norm as inn

torch.set_num_threads(2)

EPS, SLOPE = 1e-5, 0.01
# (B, C, D, H, W): a ragged voxel count, nnU-Net's two deepest stages, a
# width that takes one value a load, and an instance above the fused size
SHAPES = {"ragged": (3, 24, 5, 7, 3), "4x320": (2, 320, 4, 4, 4), "8x320": (2, 320, 8, 8, 8),
          "c6": (2, 6, 9, 5, 11), "two_pass": (2, 32, 11, 13, 9)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _input(shape, dtype=torch.float32, device="cpu", seed=0, offset=0.0, spread=1.0):
    """A seeded channels-last activation with a mean and scale of its own
    per channel, as a conv with a bias gives."""
    gen = torch.Generator().manual_seed(seed)
    view = (1, shape[1]) + (1,) * (len(shape) - 2)
    x = torch.randn(shape, generator=gen) * (0.5 + torch.rand(view, generator=gen)) + torch.randn(view, generator=gen)
    x = offset + spread * x
    return x.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last_3d)


def _affine(c, device="cpu", seed=2):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(c, generator=gen) + 0.5).to(device), torch.randn(c, generator=gen).to(device)


def _chain(x, w, b):
    return F.leaky_relu(group_norm(x, x.shape[1], w, b, EPS), SLOPE)


def _close(got, want, rtol=1e-5):
    scale = float(want.abs().max()) or 1.0
    assert float((got.float() - want.float()).abs().max()) <= rtol * scale


def _within_bf16_ulps(got, want, ulps: int) -> None:
    want = want.float()
    bound = ulps * 2.0 ** -8 * want.abs() + 1e-6 * float(want.abs().max())
    assert bool(((got.float() - want).abs() <= bound).all())


def _bf16_ulps(a, b) -> int:
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i + 32768))

    return int((ordered(a) - ordered(b)).abs().max())


def _f32_ulps(a, b) -> int:
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i >= 0, i, -(i + 2 ** 31))

    return int((ordered(a) - ordered(b)).abs().max())


def _ulps(a, b) -> int:
    return _bf16_ulps(a, b) if a.dtype == torch.bfloat16 else _f32_ulps(a, b)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_passes_are_the_group_norm_chain_in_float32(name):
    x = _input(SHAPES[name])
    w, b = _affine(x.shape[1])
    y, mean, invstd = inn.forward(x, w, b, EPS, SLOPE)
    _close(y, _chain(x, w, b))
    assert y.dtype == torch.float32 and y.is_contiguous(memory_format=torch.channels_last_3d)
    var, want_mean = torch.var_mean(x.double(), dim=(2, 3, 4), correction=0)
    torch.testing.assert_close(mean.double(), want_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(invstd.double(), (var + EPS).rsqrt(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_passes_are_within_one_bf16_ulp_of_the_chain(name):
    x = _input(SHAPES[name], torch.bfloat16)
    w, b = _affine(x.shape[1])
    y, _, _ = inn.forward(x, w, b, EPS, SLOPE)
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last_3d)
    _within_bf16_ulps(y, _chain(x.float(), w, b), 1)
    _within_bf16_ulps(y, _chain(x, w, b), 2)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_the_plain_backward_is_autograd_of_the_chain(name):
    x = _input(SHAPES[name])
    w, b = _affine(x.shape[1])
    dy = _input(SHAPES[name], seed=1)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    _chain(*leaves).backward(dy)
    got = [t.clone().requires_grad_() for t in (x, w, b)]
    inn.instance_norm_leaky_relu(*got, EPS, SLOPE).backward(dy)
    for g, want in zip(got, leaves):
        _close(g.grad, want.grad)
    assert got[0].grad.is_contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_statistics_hold_when_the_mean_is_a_hundred_times_the_spread(dtype):
    x = _input((2, 16, 9, 10, 11), dtype, offset=100.0, spread=0.01 if dtype == torch.float32 else 0.5)
    var, mean = torch.var_mean(x.double(), dim=(2, 3, 4), correction=0)
    assert float((mean.abs() / var.sqrt()).min()) > 100
    got_mean, got_invstd = inn.statistics(x, EPS)
    torch.testing.assert_close(got_mean.double(), mean, rtol=1e-6, atol=0)
    torch.testing.assert_close(got_invstd.double(), (var + EPS).rsqrt(), rtol=1e-5, atol=0)


def test_cpu_tensors_launch_nothing_and_take_any_layout():
    x = _input(SHAPES["two_pass"], torch.bfloat16)
    w, b = _affine(x.shape[1])
    before = (inn.launches, inn.x_copies, inn.dy_copies)
    y = inn.instance_norm_leaky_relu(x.contiguous(), w, b, EPS, SLOPE)
    assert torch.equal(y, inn.instance_norm_leaky_relu(x, w, b, EPS, SLOPE))
    assert (inn.launches, inn.x_copies, inn.dy_copies) == before


@pytest.mark.parametrize("name, launches", [("ragged", 1), ("4x320", 1), ("8x320", 1), ("c6", 1),
                                            ("two_pass", 3)])
def test_one_kernel_a_direction_up_to_the_fused_size(name, launches):
    x = torch.empty(SHAPES[name], device="meta")
    assert inn.launches_per_call(x) == launches
    # nnU-Net's 128³ crop: 16 norms above the fused size (128³ … 16³), 6 at or below (8³, 4³)
    sizes = [(32, 128), (64, 64), (128, 32), (256, 16), (320, 8), (320, 4)]
    norms = [4, 4, 4, 4, 4, 2]
    per_step = sum(n * inn.launches_per_call(torch.empty(2, c, s, s, s, device="meta"))
                   for n, (c, s) in zip(norms, sizes))
    assert per_step == 54 and inn.FUSED_VOXELS == 1024


def test_kernel_launches_count_and_under_a_profiler_the_counter():
    from torch.profiler import ProfilerActivity, profile

    before = inn.launches
    profiling.reset_counters()
    inn._launched(0, "statistics", 2)
    assert inn.launches == before + 2 and "norm.instance_kernels" not in profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        inn._launched(0, "normalize", 1)
        inn._launched(0, "fused backward", 1)
    assert inn.launches == before + 4 and profiling.counters()["norm.instance_kernels"] == 2
    with pytest.raises(RuntimeError, match="backward elemt launch failed: CUDA error 1"):
        inn._launched(1, "backward elemt", 1)
    assert inn.launches == before + 4
    profiling.reset_counters()


def test_what_the_kernels_do_not_take_raises():
    with pytest.raises(RuntimeError, match="no InstanceNorm implementation"):
        inn.statistics(torch.zeros(2, 8, 2, 2, 2, device="meta"), EPS)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        inn._geometry(torch.zeros(2, 8, 2, 2, 2, dtype=torch.float16))
    with pytest.raises(ValueError, match="non-empty"):
        inn._geometry(torch.zeros(0, 8, 2, 2, 2))
    x = torch.zeros(2, 8, 2, 2, 2)
    with pytest.raises(ValueError, match="expected"):
        inn._gradient(torch.zeros(2, 8, 2, 2, 2, dtype=torch.bfloat16), x)


def test_layouts_the_kernels_read_and_the_copies_they_count():
    x = _input((2, 8, 3, 4, 5))
    rows, copied = inn._aligned_rows(x)
    assert not copied and rows.shape == (2, 60, 8) and rows.data_ptr() == x.data_ptr()
    rows, copied = inn._aligned_rows(x.contiguous())
    assert copied and torch.equal(rows, x.movedim(1, -1).reshape(2, 60, 8))
    before = inn.dy_copies
    inn._gradient(x.contiguous(), x)
    assert inn.dy_copies == before + 1


def test_remat_counts_the_values_once():
    torch.manual_seed(0)
    net = PlainConvUNet3D(1, 3, (4, 8, 8)).to(memory_format=torch.channels_last_3d)
    x = torch.randn(2, 8, 8, 8, 1)
    counted = []
    for remat in (False, True):
        net.remat = remat
        profiling.reset_counters()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            sum(o.square().mean() for o in net(x)).backward()
        counted.append(profiling.counters()["norm.instance_values"])
    # two norms a block: 4 at 8³, 8 at 4³, 8 at 2³ (encoder), 8 at 4³ and 4 at 8³ (decoder)
    assert counted[0] == counted[1] == 2 * 2 * (4 * 512 + 8 * 64 + 8 * 8 + 8 * 64 + 4 * 512)
    norm = InstanceNorm3D(4)
    norm.recomputing = True
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        norm(torch.randn(2, 4, 2, 2, 2))
    assert "norm.instance_values" not in profiling.counters()
    profiling.reset_counters()


# ---- the kernels on the card -------------------------------------------------------------------

def _stats_close(mean, invstd, want_mean, want_invstd):
    spread = 1.0 / want_invstd
    assert bool(((mean - want_mean).abs() <= 1e-5 * (want_mean.abs() + spread)).all())
    assert bool(((invstd - want_invstd).abs() <= 1e-5 * want_invstd).all())


def _sums_close(x, dy, w, b, mean, invstd, sums):
    """sums against the plain ones, within 1e-5 of the sums of the terms' magnitudes."""
    want = inn.backward_reduce_reference(x, dy, w, b, mean, invstd, SLOPE)
    xhat, g = inn._through(x, dy, w, b, mean, invstd, SLOPE)
    scale = torch.cat([g.abs().sum(1), (g * xhat).abs().sum(1)], dim=1)
    assert bool(((sums - want).abs() <= 1e-5 * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(SHAPES) + ["stage64"])
def test_each_kernel_matches_its_plain_version_on_card(cuda, name, dtype):
    shape = SHAPES.get(name, (2, 64, 32, 32, 32))
    x, dy = _input(shape, dtype, cuda), _input(shape, dtype, cuda, seed=1)
    w, b = _affine(shape[1], cuda)
    want_mean, want_invstd = inn.statistics_reference(x, EPS)

    before = inn.launches
    mean, invstd = inn.statistics(x, EPS)
    assert inn.launches == before + 2
    _stats_close(mean, invstd, want_mean, want_invstd)
    again = inn.statistics(x, EPS)
    assert torch.equal(again[0], mean) and torch.equal(again[1], invstd)  # the same bits on every call

    y = inn.normalize(x, w, b, mean, invstd, SLOPE)
    assert y.dtype == dtype and y.shape == x.shape and y.stride() == x.stride()
    assert _ulps(y, inn.normalize_reference(x, w, b, mean, invstd, SLOPE)) <= 1

    sums, grad_w, grad_b = inn.backward_reduce(x, dy, w, b, mean, invstd, SLOPE)
    _sums_close(x, dy, w, b, mean, invstd, sums)
    c = shape[1]
    torch.testing.assert_close(grad_b, sums[:, :c].sum(0), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grad_w, sums[:, c:].sum(0), rtol=1e-6, atol=1e-6)
    assert torch.equal(inn.backward_reduce(x, dy, w, b, mean, invstd, SLOPE)[0], sums)

    dx = inn.backward_elemt(x, dy, w, b, mean, invstd, sums, SLOPE)
    assert dx.dtype == dtype and dx.stride() == x.stride()
    assert _ulps(dx, inn.backward_elemt_reference(x, dy, w, b, mean, invstd, sums, SLOPE)) <= 1
    assert inn.launches == before + 10

    if inn.launches_per_call(x) == 1:
        y1, m1, s1 = inn.fused_forward(x, w, b, EPS, SLOPE)
        _stats_close(m1, s1, want_mean, want_invstd)
        assert _ulps(y1, inn.normalize_reference(x, w, b, m1, s1, SLOPE)) <= 1 and y1.stride() == x.stride()
        y2, m2, s2 = inn.fused_forward(x, w, b, EPS, SLOPE)
        assert torch.equal(y1, y2) and torch.equal(m1, m2) and torch.equal(s1, s2)
        dx1, sums1, gw1, gb1 = inn.fused_backward(x, dy, w, b, m1, s1, SLOPE)
        _sums_close(x, dy, w, b, m1, s1, sums1)
        assert _ulps(dx1, inn.backward_elemt_reference(x, dy, w, b, m1, s1, sums1, SLOPE)) <= 1
        torch.testing.assert_close(gb1, sums1[:, :c].sum(0), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(gw1, sums1[:, c:].sum(0), rtol=1e-6, atol=1e-6)
        assert torch.equal(inn.fused_backward(x, dy, w, b, m1, s1, SLOPE)[0], dx1)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["4x320", "two_pass"])
def test_statistics_hold_when_the_mean_is_a_hundred_times_the_spread_on_card(cuda, name):
    x = _input(SHAPES[name], torch.bfloat16, cuda, offset=100.0, spread=0.5)
    var, mean = torch.var_mean(x.double(), dim=(2, 3, 4), correction=0)
    assert float((mean.abs() / var.sqrt()).min()) > 100
    w, b = _affine(x.shape[1], cuda)
    _, got_mean, got_invstd = inn.forward(x, w, b, EPS, SLOPE)
    torch.testing.assert_close(got_mean.double(), mean, rtol=1e-6, atol=0)
    torch.testing.assert_close(got_invstd.double(), (var + EPS).rsqrt(), rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["8x320", "two_pass"])
def test_the_autograd_function_on_card_against_the_plain_one(cuda, name):
    """The stated launches a direction, the gradients against the plain
    function's on the CPU; a gradient in another layout is copied into
    channels-last, counted, and gives the same dx."""
    x, dy = _input(SHAPES[name], torch.bfloat16, seed=3), _input(SHAPES[name], torch.bfloat16, seed=4)
    w, b = _affine(x.shape[1])
    cpu = [t.clone().requires_grad_() for t in (x, w, b)]
    inn.instance_norm_leaky_relu(*cpu, EPS, SLOPE).backward(dy)
    card = [t.to(cuda).requires_grad_() for t in (x, w, b)]
    before, copies = inn.launches, inn.dy_copies
    y = inn.instance_norm_leaky_relu(*card, EPS, SLOPE)
    per = inn.launches_per_call(x)
    assert inn.launches == before + per
    y.backward(dy.to(cuda))
    assert inn.launches == before + 2 * per and inn.dy_copies == copies
    assert _bf16_ulps(y.detach().cpu(), inn.instance_norm_leaky_relu(x, w, b, EPS, SLOPE)) <= 1
    for g, want in zip(card, cpu):
        _close(g.grad.cpu(), want.grad, rtol=2 ** -7)
    saved = [t.detach() for t in card]
    _, mean, invstd = inn.forward(*saved, EPS, SLOPE)
    dx = inn.backward(saved[0], dy.to(cuda), saved[1], saved[2], mean, invstd, SLOPE)[0]
    assert torch.equal(inn.backward(saved[0], dy.to(cuda).contiguous(), saved[1], saved[2], mean, invstd,
                                    SLOPE)[0], dx)
    assert inn.dy_copies == copies + 1


@pytest.mark.gpu
def test_a_small_nnunet_step_on_card_launches_the_stated_count(cuda):
    torch.manual_seed(0)
    net = PlainConvUNet3D(1, 3, (8, 16, 32, 32)).to(cuda, memory_format=torch.channels_last_3d)
    x = torch.randn(2, 64, 64, 64, 1, device=cuda)
    norms = [m for m in net.modules() if isinstance(m, InstanceNorm3D)]
    shapes = []
    hooks = [m.register_forward_hook(lambda m, a, o: shapes.append(a[0].shape)) for m in norms]
    before = inn.launches
    with torch.autocast("cuda", dtype=torch.bfloat16):
        outs = net(x)
    forward = inn.launches - before
    sum(o.float().square().mean() for o in outs).backward()
    for h in hooks:
        h.remove()
    stated = sum(inn.launches_per_call(torch.empty(s, device="meta")) for s in shapes)
    assert len(shapes) == 14 and forward == stated and inn.launches - before == 2 * stated
    assert all(torch.isfinite(p.grad).all() for m in norms for p in m.parameters())


def test_the_smokes_byte_counts_stated_launches_and_paths(monkeypatch):
    import os

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    a = 2 * 32 * 128 ** 3 * 2  # one bf16 activation at 128³ × 32, B=2
    need = chip_smoke.in_kernel_bytes((2, 32, 128, 128, 128), 2)
    assert need["stats"] == a + 8 * 64 and need["normalize"] == 2 * a + 8 * 64 + 8 * 32
    assert need["backward_elemt"] == 3 * a + 16 * 64 + 8 * 32 and need["fused_backward"] == 3 * a + 16 * 64 + 16 * 32
    assert chip_smoke.IN_STEP_KERNELS == 2 * 54 and chip_smoke.IN_STEP_VALUES == 2 * 357_212_160
    # Swin UNETR at 96³, F = 48: 5 norms at or under 1,024 voxels (3³ and 6³) of one kernel, 21 of three
    f, v = 48, lambda level: (96 // 2 ** level) ** 3
    per_crop = (3 * f * v(0) + 2 * f * v(1) + 2 * 2 * f * v(2) + 2 * 4 * f * v(3) + 2 * 16 * f * v(5)
                + 3 * 8 * f * v(4) + 3 * 4 * f * v(3) + 3 * 2 * f * v(2) + 3 * f * v(1) + 3 * f * v(0))
    assert chip_smoke.IN_SWIN_STEP_KERNELS == 2 * (5 + 3 * 21) and chip_smoke.IN_SWIN_STEP_VALUES == 4 * per_crop
    assert [inn.launches_per_call(torch.empty(s, device="meta")) for _, s in chip_smoke.IN_SWIN_CASES] == [3, 1]
    monkeypatch.setattr(inn, "launches", 5)
    paths = {"unet3d": 1}
    chip_smoke.take_in_launches(paths, "unet3d")
    chip_smoke.take_in_launches(paths, "serving")
    assert paths == {"unet3d": 6, "serving": 0} and inn.launches == 0
