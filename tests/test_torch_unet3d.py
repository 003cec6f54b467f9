"""The port's 3D U-Net, its encoder half, its GroupNorm and its weight
converter against the JAX package's, on the CPU.

Weights come from the flax ``init`` through ``core/convert.py``; inputs are
numpy, made from a seed; f32 on both sides, at ``features=(4, 8, 16)`` on
8×16×16 crops. Outputs and BatchNorm statistics are compared by
max|a-b| / max|b| per tensor and held to 1e-4, as the 2D model tests are:
the two frameworks sum a convolution's products in different orders.
Gradients of the Dice loss are held to 1e-3 by the same measure per
parameter. A remat forward must equal the plain one to the bit, and the
pure data movement (the upsample) exactly.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from medical_image_segmentation_tpu.models import unet3d as junet3d
from medical_image_segmentation_tpu.ops.dice import dice_loss as jax_dice_loss
from medical_image_segmentation_tpu_torch.core.convert import (
    flax_to_state_dict, torch_name, unet3d_flax_to_state_dict, unet3d_torch_name,
)
from medical_image_segmentation_tpu_torch.models.byol import BYOLNet
from medical_image_segmentation_tpu_torch.models.unet3d import (
    GroupNorm, UNet3D, UNet3DEncoder, group_norm, nearest_upsample_3d,
)
from medical_image_segmentation_tpu_torch.ops.dice import dice_loss

torch.set_num_threads(2)

TOL, GRAD_TOL = 1e-4, 1e-3
FEATURES = (4, 8, 16)
SHAPE = (2, 8, 16, 16, 1)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _flax(cls, norm, **kw):
    """(module, variables with ``batch_stats`` always present) from the flax init."""
    model = cls(features=FEATURES, norm=norm, dtype=jnp.float32, **kw)
    variables = jax.device_get(model.init(jax.random.key(0), jnp.zeros(SHAPE), train=True))
    return model, {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}


def _perturbed(variables, seed=1):
    """The init has unit scales and zero biases; move them so that a swapped
    or dropped one shows."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), variables)


def test_nearest_upsample_3d_is_the_jax_broadcast():
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 5, 6)).astype(np.float32)  # NDHWC
    want = junet3d.nearest_upsample_3d(jnp.asarray(x), 2)
    t = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got = nearest_upsample_3d(t, 2)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want))
    bf = nearest_upsample_3d(t.bfloat16(), 2)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf.float(), got.bfloat16().float())


@pytest.mark.parametrize("channels,groups", [(16, 8), (4, 4), (6, 2)])
def test_group_norm_is_flax_group_norm_with_its_epsilon(channels, groups):
    """Against flax at its default epsilon of 1e-6, on an input with a
    group of small values around 0 (what zero padding leaves behind a
    conv), where torch's default 1e-5 differs visibly."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 5, channels)).astype(np.float32)
    x[0, ..., : channels // groups] *= 3e-3
    gn = nn.GroupNorm(num_groups=groups, dtype=jnp.float32)
    params = _perturbed(jax.device_get(gn.init(jax.random.key(0), jnp.asarray(x))))
    want = np.asarray(gn.apply(params, jnp.asarray(x)))
    w, b = (torch.from_numpy(params["params"][k]) for k in ("scale", "bias"))
    t = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got = group_norm(t, groups, w, b, 1e-6)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert _rel(got.permute(0, 2, 3, 4, 1).numpy(), want) <= TOL
    assert _rel(F.group_norm(t, groups, w, b, 1e-6).permute(0, 2, 3, 4, 1).numpy(), want) <= TOL
    torch_default = F.group_norm(t, groups, w, b, 1e-5).permute(0, 2, 3, 4, 1).numpy()
    assert _rel(torch_default, want) > 100 * TOL  # why eps is passed
    assert GroupNorm(groups, channels).eps == 1e-6
    with pytest.raises(ValueError, match="do not divide"):
        GroupNorm(4, 6)


def test_group_norm_rounds_once_to_the_input_dtype_and_has_the_f32_gradient():
    x = torch.randn(2, 8, 3, 4, 5, generator=torch.Generator().manual_seed(2))
    w, b = torch.rand(8) + 0.5, torch.randn(8)
    bf = group_norm(x.bfloat16(), 4, w, b, 1e-6)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, group_norm(x.bfloat16().float(), 4, w, b, 1e-6).bfloat16())  # f32 inside, one rounding
    ours, lib = x.clone().requires_grad_(), x.clone().requires_grad_()
    group_norm(ours, 4, w, b, 1e-6).square().sum().backward()
    F.group_norm(lib, 4, w, b, 1e-6).square().sum().backward()
    assert _rel(ours.grad.numpy(), lib.grad.numpy()) <= TOL


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_unet3d_matches_flax_in_train_and_eval_mode(norm):
    model, variables = _flax(junet3d.UNet3D, norm)
    variables = _perturbed(variables) if norm == "group" else variables
    net = UNet3D(features=FEATURES, norm=norm).to(memory_format=torch.channels_last_3d)
    net.load_state_dict(unet3d_flax_to_state_dict(variables["params"], variables["batch_stats"]))
    x = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    flax_vars = {k: v for k, v in variables.items() if v}

    jout, mut = model.apply(flax_vars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    net.train()
    tout = net(torch.from_numpy(x))
    assert tout.dtype == torch.float32 and tuple(tout.shape) == jout.shape == SHAPE
    assert _rel(tout.detach().numpy(), jout) <= TOL
    if norm == "batch":
        new_stats = jax.device_get(mut["batch_stats"])
        want = unet3d_flax_to_state_dict({}, new_stats)
        got = {k: v for k, v in net.state_dict().items() if "running" in k}
        assert set(got) == set(want) and len(want) == 2 * 2 * 5
        for k in want:
            assert _rel(got[k].numpy(), want[k].numpy()) <= TOL, k
        flax_vars = {**flax_vars, "batch_stats": new_stats}
    else:
        assert not any("running" in k for k in net.state_dict())

    jeval = model.apply(flax_vars, jnp.asarray(x), train=False)
    net.eval()
    with torch.no_grad():
        teval = net(torch.from_numpy(x))
    assert _rel(teval.numpy(), jeval) <= TOL


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_encoder_matches_flax_and_sits_under_the_byol_backbone(norm):
    model, variables = _flax(junet3d.UNet3DEncoder, norm)
    sd = flax_to_state_dict({"UNet3DEncoder_0": variables["params"]}, {"UNet3DEncoder_0": variables["batch_stats"]})
    assert all(k.startswith("backbone.") for k in sd)
    net = UNet3DEncoder(features=FEATURES, norm=norm)
    net.load_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()})
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    want, _ = model.apply({k: v for k, v in variables.items() if v}, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, FEATURES[-1]) == want.shape
    assert net.feature_dim == FEATURES[-1] and _rel(got.detach().numpy(), want) <= TOL


def test_dice_gradients_match_flax():
    model, variables = _flax(junet3d.UNet3D, "group")
    variables = _perturbed(variables)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    y = (rng.random(SHAPE) < 0.3).astype(np.float32)
    grads = jax.grad(lambda p: jax_dice_loss(model.apply({"params": p}, jnp.asarray(x), train=True), jnp.asarray(y)))(
        variables["params"])
    want = unet3d_flax_to_state_dict(jax.device_get(grads), {})
    net = UNet3D(features=FEATURES)
    net.load_state_dict(unet3d_flax_to_state_dict(variables["params"], {}))
    dice_loss(net(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    got = {k: p.grad for k, p in net.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k].numpy(), want[k].numpy()) <= GRAD_TOL, (k, _rel(got[k].numpy(), want[k].numpy()))


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_remat_forward_and_gradients_equal_the_plain_ones_to_the_bit(norm):
    plain, remat = UNet3D(features=FEATURES, norm=norm), UNet3D(features=FEATURES, norm=norm, remat=True)
    plain.reset_parameters(torch.Generator().manual_seed(0))
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(1))
    outs = []
    for net in (plain, remat):
        out = net(x)
        out.square().mean().backward()
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    for (k, a), (_, b) in zip(plain.named_parameters(), remat.named_parameters()):
        assert torch.equal(a.grad, b.grad), k
    for (k, a), (_, b) in zip(plain.named_buffers(), remat.named_buffers()):
        assert torch.equal(a, b), k  # the recompute leaves BatchNorm's running statistics alone
    with torch.no_grad():
        assert torch.equal(remat(x), outs[0])


@pytest.mark.parametrize("cls,jcls", [(UNet3D, junet3d.UNet3D), (UNet3DEncoder, junet3d.UNet3DEncoder)])
@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("features", [(4, 8, 16), (32, 64, 128, 256)])
def test_every_flax_leaf_maps_to_a_torch_tensor_of_its_shape(cls, jcls, norm, features):
    """At the tests' width and the published one: no flax leaf is left
    unmapped and no torch tensor left over."""
    model = jcls(features=features, norm=norm, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=True), jnp.zeros((1, 8, 8, 8, 1)))
    sd = cls(features=features, norm=norm).state_dict()
    prefix = "" if cls is UNet3D else "UNet3DEncoder_0/"
    seen = set()
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes.get(col, {}))[0]:
            flax_path = prefix + "/".join(p.key for p in path)
            name, fn = (unet3d_torch_name if cls is UNet3D else torch_name)(flax_path)
            name = name.removeprefix("backbone.")
            assert tuple(sd[name].shape) == fn(np.zeros(leaf.shape)).shape, name
            seen.add(name)
    assert seen == set(sd)


def test_volumetric_byol_net_converts_leaf_for_leaf():
    from medical_image_segmentation_tpu.models.byol import BYOLNet as JaxBYOLNet

    model = JaxBYOLNet(in_channels=1, hidden_dim=32, proj_dim=16, num_classes=2, dtype=jnp.float32, volumetric=True,
                       features3d=FEATURES)
    variables = jax.device_get(model.init(jax.random.key(0), jnp.zeros(SHAPE), train=True))
    sd = flax_to_state_dict(variables["params"], variables["batch_stats"])
    net = BYOLNet(in_channels=1, hidden_dim=32, proj_dim=16, num_classes=2, volumetric=True, features3d=FEATURES)
    net.load_state_dict(sd)  # strict: the key sets are equal
    assert net.encoder.backbone.feature_dim == FEATURES[-1] == net.probe.in_features
    x = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    want, _ = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = net(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert _rel(g.detach().numpy(), w) <= TOL


def test_converter_raises_on_an_unknown_leaf():
    k3 = np.zeros((3, 3, 3, 4, 4))
    for bad in ({"enc0": {"Conv_2": {"kernel": k3}}}, {"mid0": {"Conv_0": {"kernel": k3}}},
                {"enc0": {"LayerNorm_0": {"scale": np.zeros(4)}}}, {"down0": {"bias": np.zeros(4)}}):
        with pytest.raises(KeyError, match="no torch counterpart"):
            unet3d_flax_to_state_dict(bad, {})
    with pytest.raises(KeyError, match="no torch counterpart"):
        torch_name("encoder/UNet3DEncoder_0/dec0/Conv_0/kernel")  # the encoder half has no decoder
    with pytest.raises(KeyError, match="no torch counterpart"):
        torch_name("encoder/enc0/Conv_0/kernel")  # the bare U-Net paths are not BYOL paths
    sd = unet3d_flax_to_state_dict({"enc1": {"Conv_0": {"kernel": np.arange(27 * 2 * 5.0).reshape(3, 3, 3, 2, 5)}}}, {})
    w = sd["enc1.conv1.weight"]  # DHWIO → OIDHW
    assert tuple(w.shape) == (5, 2, 3, 3, 3) and float(w[4, 1, 2, 0, 1]) == ((2 * 3 + 0) * 3 + 1) * 10 + 1 * 5 + 4


def test_init_is_flax_like():
    net = UNet3D(features=(8, 16))
    net.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(net.head.bias, torch.zeros(1))
    std = (1.0 / 8) ** 0.5 / 0.87962566103423978
    assert float(net.head.weight.detach().abs().max()) <= 2 * std
    w = net.enc1.conv2.weight.detach()  # Kaiming fan_out: std sqrt(2 / (16·27))
    want = (2.0 / (16 * 27)) ** 0.5
    assert abs(float(w.std()) - want) < 0.05 * want
    assert torch.equal(net.enc0.norm1.weight.detach(), torch.ones(8)) and net.enc0.norm1.groups == 8
    assert UNet3D(features=(4, 8)).enc0.norm1.groups == 4  # min(8, filters)


def test_shape_errors_carry_the_references_messages():
    with pytest.raises(ValueError, match=r"UNet3D input D/H/W must be divisible by 4 \(2 down/upsample stages\); "
                                         r"got 8x18x16\."):
        UNet3D(features=FEATURES)(torch.zeros(1, 8, 18, 16, 1))
    model = junet3d.UNet3D(features=FEATURES, dtype=jnp.float32)
    with pytest.raises(ValueError, match=r"must be divisible by 4 \(2 down/upsample stages\); got 8x18x16\."):
        model.init(jax.random.key(0), jnp.zeros((1, 8, 18, 16, 1)), train=True)
    for net in (UNet3D(features=FEATURES), UNet3DEncoder(features=FEATURES)):
        with pytest.raises(ValueError, match="expected 1 input channels"):
            net(torch.zeros(1, 8, 16, 16, 3))
    with pytest.raises(ValueError, match="norm must be"):
        UNet3D(norm="layer")
