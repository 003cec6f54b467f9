"""One card's training BatchNorm on the hand-written kernels' path
(``models/batchnorm.py::_LocalNormalize`` over ``ops/global_batchnorm.py``):
on CPU tensors it runs the passes' plain float32 versions, which are held
here to ``F.batch_norm``'s autograd, the call it replaces on the card, and
to flax's running-statistics update; the module's choice of path; the
``bn.local_kernels`` counter. The card tests run the kernels through the
module against ``F.batch_norm`` on the card.

This file imports no JAX, so that it also runs on a machine with a card and
without JAX: ``python -m pytest --noconftest tests/test_torch_local_batchnorm.py -q``.
Tests that need the card are marked ``gpu`` and skip without one.

Tolerances. In float32 the two sides differ by the order of their sums and
the variance's form (E[x²] − E[x]² against torch's two-pass variance): at
these sizes and a channel mean within a few standard deviations, 1e-5 of
the largest magnitude (each side's scale and bias gradients, sums of a few
hundred terms, lie within 8e-6 of it from float64). On the card in bfloat16 both round once to the
dtype: within two bf16 ulp at each value's magnitude (2^-7 of it) of each
other, beyond 1e-3 of the largest magnitude for the float32 sums' order.
"""

import pytest
import torch
import torch.nn.functional as F

from medical_image_segmentation_tpu_torch.core import profiling
from medical_image_segmentation_tpu_torch.models import batchnorm
from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm
from medical_image_segmentation_tpu_torch.ops import global_batchnorm as gbn

torch.set_num_threads(2)

EPS, MOMENTUM = 1e-5, 0.9
# (N, C, ...) as the one-card models hand them over: the MLP heads' 2-D, ResNet's and the U-Net's
# channels_last 4-D, UNet3D's channels_last_3d 5-D
LAYOUTS = {"2d": ((37,), torch.contiguous_format), "4d": ((3, 7, 11), torch.channels_last),
           "5d": ((3, 3, 5, 7), torch.channels_last_3d)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _input(layout: str, c: int, seed: int = 0, device="cpu", dtype=torch.float32):
    """A seeded activation with a mean and scale of its own per channel, as
    a convolution's output has."""
    dims, fmt = LAYOUTS[layout]
    shape = (dims[0], c, *dims[1:])
    gen = torch.Generator().manual_seed(seed)
    view = (1, c) + (1,) * (len(shape) - 2)
    x = torch.randn(shape, generator=gen) * (0.5 + torch.rand(view, generator=gen)) + torch.randn(view, generator=gen)
    return x.to(device=device, dtype=dtype).contiguous(memory_format=fmt)


def _bn(c: int, seed: int = 3, device="cpu") -> BatchNorm:
    """A training BatchNorm with a seeded affine map and running statistics."""
    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c, momentum=MOMENTUM, eps=EPS)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=gen))
        bn.running_mean.copy_(torch.randn(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return bn.to(device).train()


def _twin(bn: BatchNorm) -> BatchNorm:
    twin = BatchNorm(bn.weight.numel(), momentum=bn.momentum, eps=bn.eps).to(bn.weight.device).train()
    twin.load_state_dict(bn.state_dict())
    return twin


def _run(bn: BatchNorm, x: torch.Tensor, dy: torch.Tensor):
    """y and the gradients of x, the scale and the bias."""
    x = x.detach().clone().requires_grad_(True)
    bn.zero_grad()
    y = bn(x)
    y.backward(dy)
    return y.detach(), x.grad, bn.weight.grad.clone(), bn.bias.grad.clone()


@pytest.fixture
def kernel_path(monkeypatch):
    """``BatchNorm`` takes the one-card kernels' path for a CPU tensor too,
    where ``_LocalNormalize`` runs the plain passes."""
    monkeypatch.setattr(gbn, "takes", lambda x: True)


@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_local_path_matches_f_batch_norm_autograd(kernel_path, monkeypatch, layout, c):
    x, dy = _input(layout, c), _input(layout, c, seed=1)
    bn = _bn(c)
    library = _twin(bn)
    calls = []
    apply = batchnorm._LocalNormalize.apply
    monkeypatch.setattr(batchnorm._LocalNormalize, "apply", lambda *a: calls.append(1) or apply(*a))
    got = _run(bn, x, dy)
    assert calls == [1]
    # the F.batch_norm call of the same module, as one card ran it before the kernels
    xw = x.detach().clone().requires_grad_(True)
    want = F.batch_norm(xw, None, None, library.weight, library.bias, True, 0.0, EPS)
    want.backward(dy)
    assert got[0].dtype == x.dtype and got[0].stride() == x.stride() and got[1].stride() == x.stride()
    for name, g, w in zip(("y", "dx", "dw", "db"), got, (want.detach(), xw.grad, library.weight.grad,
                                                        library.bias.grad)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()), msg=name)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_local_path_ends_the_running_statistics_at_flax_s_update(kernel_path, layout, monkeypatch):
    """The kernels' path and the ``F.batch_norm`` path of ``BatchNorm.forward``
    both end at flax's update: m·old + (1 − m)·(batch mean, biased variance)."""
    x = _input(layout, 16)
    bn = _bn(16)
    library = _twin(bn)
    old_mean, old_var = bn.running_mean.clone(), bn.running_var.clone()
    bn(x)
    monkeypatch.setattr(gbn, "takes", lambda x: False)
    library(x)
    xd = x.double().transpose(0, 1).reshape(16, -1)
    want_mean = MOMENTUM * old_mean.double() + (1 - MOMENTUM) * xd.mean(1)
    want_var = MOMENTUM * old_var.double() + (1 - MOMENTUM) * xd.var(1, unbiased=False)
    for got in (bn, library):
        torch.testing.assert_close(got.running_mean.double(), want_mean, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got.running_var.double(), want_var, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_recomputing_leaves_the_running_statistics_alone(kernel_path, layout):
    x, dy = _input(layout, 8), _input(layout, 8, seed=1)
    bn = _bn(8)
    first = _twin(bn)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    with batchnorm.recomputing([bn]):
        again = _run(bn, x, dy)
    assert all(torch.equal(v, before[k]) for k, v in bn.state_dict().items())
    for g, w in zip(again, _run(first, x, dy)):  # the same normalize as the step's first run
        assert torch.equal(g, w)
    assert not torch.equal(first.running_mean, bn.running_mean)


def test_local_path_keeps_the_refusal_of_one_value_a_channel(kernel_path):
    with pytest.raises(ValueError, match="more than one value per channel"):
        _bn(8)(torch.randn(1, 8))


@pytest.mark.parametrize("what, kernels", [("stats", 2), ("normalize", 1), ("backward reduce", 2),
                                           ("backward elemt", 1)])
def test_local_launches_move_the_counter_only_under_a_profiler(what, kernels):
    from torch.profiler import ProfilerActivity, profile

    before, global_before = gbn.local_launches, gbn.launches
    profiling.reset_counters()
    gbn._launched(0, what, kernels, local=True)
    assert gbn.local_launches == before + kernels and profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        gbn._launched(0, what, kernels, local=True)
    assert gbn.local_launches == before + 2 * kernels
    assert profiling.counters() == {"bn.local_kernels": kernels}  # not the global path's counter
    assert gbn.launches == global_before
    with pytest.raises(RuntimeError, match=f"{what} launch failed: CUDA error 2"):
        gbn._launched(2, what, kernels, local=True)
    assert gbn.local_launches == before + 2 * kernels
    profiling.reset_counters()


@pytest.mark.parametrize("takes, group, training, path", [
    (True, None, True, "local"),
    (False, None, True, "library"),  # a layout the kernels refuse keeps F.batch_norm
    (True, "ranks", True, "global"),
    (False, "ranks", True, "global"),
    (True, None, False, "library"),  # eval: the running statistics, F.batch_norm
])
def test_the_module_chooses_its_path(monkeypatch, takes, group, training, path):
    seen = []
    monkeypatch.setattr(gbn, "takes", lambda x: takes)
    monkeypatch.setattr(batchnorm, "all_reduce_", lambda t, g: t)  # a group of one rank
    for name, cls in (("local", batchnorm._LocalNormalize), ("global", batchnorm._GlobalNormalize)):
        monkeypatch.setattr(cls, "apply", (lambda name, f: lambda *a: seen.append(name) or f(*a))(name, cls.apply))
    library = F.batch_norm
    monkeypatch.setattr(F, "batch_norm", lambda *a, **k: seen.append("library") or library(*a, **k))
    bn = _bn(8)
    bn.group = group
    bn.train(training)
    y = bn(_input("4d", 8))
    assert seen == [path] and y.shape == (3, 8, 7, 11)


@pytest.mark.parametrize("shape, fmt, dtype, taken", [
    ((4, 8), torch.contiguous_format, torch.bfloat16, True),
    ((2, 8, 3, 3), torch.channels_last, torch.bfloat16, True),
    ((2, 8, 3, 3), torch.channels_last, torch.float32, True),
    ((2, 8, 3, 3, 3), torch.channels_last_3d, torch.bfloat16, True),
    ((2, 8, 3, 3), torch.contiguous_format, torch.bfloat16, False),  # NCHW
    ((2, 8, 3, 3, 3), torch.contiguous_format, torch.float32, False),  # NCDHW
    ((2, 8, 5), torch.contiguous_format, torch.float32, False),  # (N, C, L)
    ((2, 8, 3, 3), torch.channels_last, torch.float16, False),
    ((4, 8), torch.contiguous_format, torch.float64, False),
])
def test_takes_only_what_the_kernels_take(monkeypatch, shape, fmt, dtype, taken):
    x = torch.zeros(shape, dtype=dtype).contiguous(memory_format=fmt)
    assert not gbn.takes(x)  # a CPU tensor keeps F.batch_norm
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))  # as on the card
    assert gbn.takes(x) is taken


def test_takes_refuses_a_transposed_matrix(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    assert gbn.takes(torch.zeros(4, 8)) and not gbn.takes(torch.zeros(8, 4).t())


@pytest.mark.parametrize("takes", [True, False])
def test_the_local_span_opens_only_on_the_kernels_path(monkeypatch, takes):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(gbn, "takes", lambda x: takes)
    bn = _bn(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bn(_input("4d", 8))
    spans = [e.name for e in prof.events() if e.name.startswith("mis.bn.")]
    assert spans == (["mis.bn.local"] if takes else [])


# unet_r18.train's narrowest decoder blocks (batch 512 of 224²) and a small ragged one
CARD_SHAPES = {"small": (3, 24, 7, 11), "unet_dec16": (512, 16, 224, 224), "unet_dec32": (512, 32, 112, 112)}


def _ulp_close(got: torch.Tensor, want: torch.Tensor, name: str) -> None:
    got, want = got.float(), want.float()
    limit = 2.0 ** -7 * want.abs() + 1e-3 * want.abs().max()
    assert bool(((got - want).abs() <= limit).all()), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_SHAPES))
def test_module_on_the_kernels_matches_f_batch_norm_on_card(cuda, case):
    """The module's one-card path on the card: 3 kernels forward and 3
    backward, y and the gradients against ``F.batch_norm``'s (cuDNN)
    within the bf16 limits above, the running statistics at flax's update."""
    n, c, h, w = CARD_SHAPES[case]
    gen = torch.Generator(device=cuda).manual_seed(0)
    view = (1, c, 1, 1)
    x = (torch.randn(n, c, h, w, generator=gen, device=cuda) * (0.5 + torch.rand(view, generator=gen, device=cuda))
         + torch.randn(view, generator=gen, device=cuda)).to(torch.bfloat16).contiguous(
             memory_format=torch.channels_last)
    dy = torch.randn(n, c, h, w, generator=gen, device=cuda).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    bn = _bn(c, device=cuda)
    library = _twin(bn)
    assert gbn.takes(x)
    before = gbn.local_launches
    got = _run(bn, x, dy)
    torch.cuda.synchronize()
    assert gbn.local_launches == before + 6
    xw = x.detach().clone().requires_grad_(True)
    want = F.batch_norm(xw, None, None, library.weight, library.bias, True, 0.0, EPS)
    want.backward(dy)
    assert got[0].dtype == torch.bfloat16 and got[0].stride() == x.stride() and got[1].stride() == x.stride()
    for name, g, wt in zip(("y", "dx", "dw", "db"), got, (want.detach(), xw.grad, library.weight.grad,
                                                         library.bias.grad)):
        _ulp_close(g, wt, name)
    xd = x.double().transpose(0, 1).reshape(c, -1)
    torch.testing.assert_close(bn.running_mean.double(), MOMENTUM * library.running_mean.double()
                               + (1 - MOMENTUM) * xd.mean(1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_var.double(), MOMENTUM * library.running_var.double()
                               + (1 - MOMENTUM) * xd.var(1, unbiased=False), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_a_layout_the_kernels_refuse_keeps_f_batch_norm_on_card(cuda):
    x = _input("4d", 16, device=cuda, dtype=torch.bfloat16).contiguous()  # NCHW
    bn = _bn(16, device=cuda)
    before = gbn.local_launches
    assert not gbn.takes(x)
    y = bn(x.requires_grad_(True))
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert gbn.local_launches == before and y.is_contiguous()
