"""The port's ResNet pyramid, U-Net, U-Net weight converter and BYOL→U-Net
graft against the JAX package's, on the CPU.

Weights come from the JAX ``init`` through ``core/convert.py``; inputs are
numpy, made from a seed. f32 on both sides. Outputs and BatchNorm
statistics are compared by max|a-b| / max|b| per tensor, held to 1e-4 as
the slice-1 model tests are: the two frameworks sum a convolution's
products in different orders. The graft moves tensors and at most sums
three of them, so it is held to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.core.checkpoint import load_byol_encoder_into_unet as jax_graft
from medical_image_segmentation_tpu.models import resnet as jresnet
from medical_image_segmentation_tpu.models import unet as junet
from medical_image_segmentation_tpu.train.byol_task import BYOLTask as JaxBYOLTask
from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask as JaxSegTask
from medical_image_segmentation_tpu_torch.core import checkpoint as tckpt
from medical_image_segmentation_tpu_torch.core.convert import (
    flax_to_state_dict, torch_name, unet_flax_to_state_dict, unet_torch_name,
)
from medical_image_segmentation_tpu_torch.models.resnet import ResNet
from medical_image_segmentation_tpu_torch.models.unet import UNet, nearest_upsample

torch.set_num_threads(2)

TOL = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.mark.parametrize("low_res,size", [(False, 64), (True, 32)])
def test_resnet_pyramid_matches_jax_at_every_level(low_res, size):
    model = jresnet.make_resnet("resnet18", in_channels=1, low_res=low_res, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, size, size, 1)).astype(np.float32)
    variables = jax.device_get(model.init(jax.random.key(0), jnp.asarray(x), train=True))
    sd = {k.removeprefix("backbone."): v for k, v in
          flax_to_state_dict({"ResNet_0": variables["params"]}, {"ResNet_0": variables["batch_stats"]}).items()}
    net = ResNet("resnet18", 1, low_res)
    net.load_state_dict(sd)
    jtrain, _ = model.apply(variables, jnp.asarray(x), train=True, return_pyramid=True, mutable=["batch_stats"])
    jeval = model.apply(variables, jnp.asarray(x), train=False, return_pyramid=True)
    strides = (1, 1, 2, 4, 8) if low_res else (2, 4, 8, 16, 32)
    for mode, want in (("eval", jeval), ("train", jtrain)):  # eval first: train moves the running stats
        net.train(mode == "train")
        with torch.no_grad():
            got = net(torch.from_numpy(x), return_pyramid=True)
        assert len(got) == len(want) == 5
        for level, (g, w, s) in enumerate(zip(got, want, strides)):
            assert tuple(g.shape) == w.shape and w.shape[1] == size // s, (mode, level)
            assert _rel(g.numpy(), w) <= TOL, (mode, level, _rel(g.numpy(), w))


def test_nearest_upsample_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 5, 4)).astype(np.float32)  # NHWC
    want = junet.nearest_upsample(jnp.asarray(x), 2)
    got = nearest_upsample(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def jax_unet():
    task = JaxSegTask(arch="resnet18", dtype=jnp.float32)
    state = jax.device_get(task.init(jax.random.key(0), (2, 64, 64, 1)))
    return task, state


def test_unet_matches_jax_in_train_and_eval_mode(jax_unet):
    task, state = jax_unet
    net = UNet("resnet18", n_classes=1, in_channels=1)
    net.load_state_dict(unet_flax_to_state_dict(state.params, state.batch_stats))
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 1)).astype(np.float32)

    jout, mut = task.model.apply({"params": state.params, "batch_stats": state.batch_stats}, jnp.asarray(x),
                                 train=True, mutable=["batch_stats"])
    net.train()
    tout = net(torch.from_numpy(x))
    assert tout.dtype == torch.float32 and tuple(tout.shape) == jout.shape == (2, 64, 64, 1)
    assert _rel(tout.detach().numpy(), jout) <= TOL
    new_stats = jax.device_get(mut["batch_stats"])
    want = _numpy(unet_flax_to_state_dict({}, new_stats))
    before = _numpy(unet_flax_to_state_dict({}, state.batch_stats))
    got = {k: v.numpy() for k, v in net.state_dict().items() if "running" in k}
    assert set(got) == set(want) and any(k.startswith("decoder.") for k in want)
    for k in want:
        assert _rel(got[k], want[k]) <= TOL, (k, _rel(got[k], want[k]))
        assert not np.allclose(want[k], before[k]), k

    jeval = task.model.apply({"params": state.params, "batch_stats": new_stats}, jnp.asarray(x), train=False)
    net.eval()
    with torch.no_grad():
        teval = net(torch.from_numpy(x))
    assert _rel(teval.numpy(), jeval) <= TOL


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_unet_has_the_jax_parameter_shapes(arch):
    """Every flax leaf maps to a torch tensor of the converted shape, and no
    torch tensor is left over."""
    model = junet.UNet(arch=arch, in_channels=1, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=True), jnp.zeros((1, 64, 64, 1)))
    net = UNet(arch, in_channels=1)
    sd = net.state_dict()
    seen = set()
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[col])[0]:
            name, fn = unet_torch_name("/".join(p.key for p in path))
            assert tuple(sd[name].shape) == fn(np.zeros(leaf.shape)).shape, name
            seen.add(name)
    assert seen == set(sd)


def test_unet_init_is_flax_like():
    net = UNet("resnet18")
    net.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(net.head.bias, torch.zeros(1))
    std = (1.0 / (16 * 9)) ** 0.5 / 0.87962566103423978
    assert float(net.head.weight.detach().abs().max()) <= 2 * std
    w = net.decoder[0].conv1.weight.detach()  # Kaiming fan_out: std sqrt(2 / (256·9))
    assert abs(float(w.std()) - (2.0 / (256 * 9)) ** 0.5) < 0.05 * (2.0 / (256 * 9)) ** 0.5


def test_unet_refuses_sizes_not_divisible_by_32():
    with pytest.raises(ValueError, match="divisible by 32"):
        UNet("resnet18")(torch.zeros(1, 48, 64, 1))


def test_unet_converter_raises_on_an_unknown_leaf():
    with pytest.raises(KeyError, match="no torch counterpart"):
        unet_flax_to_state_dict({"DecoderBlock_0": {"Conv_2": {"kernel": np.zeros((3, 3, 4, 4))}}}, {})
    with pytest.raises(KeyError, match="no torch counterpart"):
        unet_flax_to_state_dict({"encoder": {"ResNet_0": {"conv1": {"kernel": np.zeros((7, 7, 1, 64))}}}}, {})
    with pytest.raises(KeyError, match="no torch counterpart"):
        torch_name("encoder/conv1/kernel")  # the BYOL rules do not take U-Net paths


@pytest.fixture(scope="module")
def byol_variables():
    """BYOL variables (3-channel and 1-channel stems) from the JAX init."""
    out = {}
    for cin in (1, 3):
        task = JaxBYOLTask(arch="resnet18", in_channels=cin, hidden_dim=32, proj_dim=16, num_classes=5,
                           dtype=jnp.float32)
        state = jax.device_get(task.init(jax.random.key(cin), (2, 64, 64, cin)))
        out[cin] = {"params": state.params, "batch_stats": state.batch_stats}
    return out


@pytest.mark.parametrize("byol_in,unet_in", [(3, 1), (1, 3), (1, 1)])
def test_graft_matches_jax(byol_variables, byol_in, unet_in):
    byol = byol_variables[byol_in]
    jt = JaxSegTask(arch="resnet18", in_channels=unet_in, dtype=jnp.float32)
    state = jax.device_get(jt.init(jax.random.key(7), (2, 64, 64, unet_in)))
    want = jax_graft({"params": state.params, "batch_stats": state.batch_stats}, byol)
    want = _numpy(unet_flax_to_state_dict(want["params"], want["batch_stats"]))

    online = flax_to_state_dict(byol["params"], byol["batch_stats"])
    unet_sd = unet_flax_to_state_dict(state.params, state.batch_stats)
    got = _numpy(tckpt.load_byol_encoder_into_unet(unet_sd, online))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert got["encoder.conv1.weight"].shape[1] == unet_in
    # the encoder is the BYOL backbone's; the decoder and head are untouched
    np.testing.assert_array_equal(got["encoder.layer4.1.bn2.running_var"],
                                  online["encoder.backbone.layer4.1.bn2.running_var"].numpy())
    np.testing.assert_array_equal(got["decoder.0.conv1.weight"], unet_sd["decoder.0.conv1.weight"].numpy())


def test_graft_raises_on_a_mismatch(byol_variables):
    online = flax_to_state_dict(byol_variables[1]["params"], byol_variables[1]["batch_stats"])
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.load_byol_encoder_into_unet(UNet("resnet34").state_dict(), online)
    bad = dict(online)
    bad["encoder.backbone.layer1.0.bn1.weight"] = torch.zeros(32)
    with pytest.raises(ValueError, match="shape mismatches"):
        tckpt.load_byol_encoder_into_unet(UNet("resnet18").state_dict(), bad)
    with pytest.raises(ValueError, match="cannot adapt"):
        tckpt._adapt_conv1(torch.zeros(64, 3, 7, 7), 2)


def test_checkpoint_files_and_latest_step(tmp_path):
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    for step in (3, 12, 7):
        tckpt.save_checkpoint(str(tmp_path), {"step": step}, step)
    (tmp_path / "notes.txt").write_text("x")
    assert tckpt.latest_step(str(tmp_path)) == 12
    assert tckpt.resolve_checkpoint_path(str(tmp_path) + "/") == str(tmp_path / "12.pt")
    assert tckpt.resolve_checkpoint_path(str(tmp_path / "7.pt")) == str(tmp_path / "7.pt")
    assert torch.load(str(tmp_path / "7.pt"), weights_only=True) == {"step": 7}
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no checkpoint steps"):
        tckpt.resolve_checkpoint_path(str(tmp_path / "empty"))
