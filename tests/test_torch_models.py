"""The port's ResNet / MLP / BYOL network against the JAX package's, on
weights converted from ``BYOLTask.init`` by ``core/convert.py``.

f32 on both sides. Outputs and BatchNorm statistics are compared by
max|a-b| / max|b| per tensor. The two frameworks sum a convolution's
products in different orders; through ResNet-18 that stays inside 1e-4.
ResNet-50 is worse conditioned at this size (16 values per BatchNorm
channel in its last stage): JAX's own f32 features are 3.4e-4 away from
an f64 forward of the same weights, so it is held to 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu.models import resnet as jresnet
from medical_image_segmentation_tpu.train.byol_task import BYOLTask as JaxBYOLTask
from medical_image_segmentation_tpu_torch.core.convert import flax_to_state_dict, torch_name
from medical_image_segmentation_tpu_torch.models import resnet as tresnet
from medical_image_segmentation_tpu_torch.models.byol import BYOLNet

torch.set_num_threads(2)



def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _torch_buffers(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items() if "running" in k}


# (arch, in_channels, low_res, image size, tolerance)
CASES = [
    ("resnet18", 1, False, 64, 1e-4),
    ("resnet50", 3, False, 64, 2e-3),
    ("resnet18", 3, True, 32, 1e-4),
]


@pytest.mark.parametrize("arch,channels,low_res,size,tol", CASES)
def test_byolnet_matches_jax_in_train_and_eval_mode(arch, channels, low_res, size, tol):
    jt = JaxBYOLTask(arch=arch, in_channels=channels, low_res=low_res, hidden_dim=32, proj_dim=16,
                     num_classes=5, dtype=jnp.float32)
    state = jt.init(jax.random.key(0), (2, size, size, channels))
    params, stats = jax.device_get(state.params), jax.device_get(state.batch_stats)
    net = BYOLNet(arch, channels, low_res, hidden_dim=32, proj_dim=16, num_classes=5)
    net.load_state_dict(flax_to_state_dict(params, stats))
    x = np.random.default_rng(1).standard_normal((4, size, size, channels)).astype(np.float32)

    # train mode: batch statistics, and the running stats move
    (jout, mut) = jt.model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    net.train()
    tout = net(torch.from_numpy(x))
    for name, t, j in zip(("p", "z", "feats", "probe"), tout, jout):
        assert t.shape == j.shape, name
        assert _rel(t.detach().numpy(), j) <= tol, (name, _rel(t.detach().numpy(), j))
    new_stats = jax.device_get(mut["batch_stats"])
    want = {k: v.numpy() for k, v in flax_to_state_dict({}, new_stats).items()}
    before = flax_to_state_dict({}, stats)
    got = _torch_buffers(net)
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))
        assert not np.allclose(want[k], before[k].numpy()), k

    # eval mode: the running stats just updated
    jeval = jt.model.apply({"params": params, "batch_stats": new_stats}, jnp.asarray(x), train=False)
    net.eval()
    with torch.no_grad():
        teval = net(torch.from_numpy(x))
    for name, t, j in zip(("p", "z", "feats", "probe"), teval, jeval):
        assert _rel(t.numpy(), j) <= tol, (name, _rel(t.numpy(), j))


@pytest.mark.parametrize("arch", sorted(jresnet.RESNET_CONFIGS))
def test_every_arch_has_the_jax_parameter_shapes(arch):
    """All nine RESNET_CONFIGS: every flax leaf maps to a torch tensor of
    the converted shape, and no torch tensor is left over."""
    model = jresnet.make_resnet(arch, in_channels=1, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=True), jnp.zeros((1, 32, 32, 1)))
    net = tresnet.ResNet(arch, in_channels=1)
    sd = net.state_dict()
    seen = set()
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[col])[0]:
            flax_path = "ResNet_0/" + "/".join(p.key for p in path)
            name, fn = torch_name(flax_path)
            name = name.removeprefix("backbone.")
            assert tuple(sd[name].shape) == fn(np.zeros(leaf.shape)).shape, name
            seen.add(name)
    assert seen == set(sd)


def test_converter_raises_on_an_unknown_leaf():
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict({"encoder": {"ResNet_0": {"conv9": {"kernel": np.zeros((3, 3, 1, 4))}}}}, {})
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict({"probe": {"scale": np.zeros(3)}}, {})


def test_batchnorm_keeps_flax_semantics():
    """momentum 0.9 keeps 0.9 of the old stat; the running variance takes
    the biased batch variance (torch's own BatchNorm takes the unbiased)."""
    from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm

    bn = BatchNorm(3)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((5, 3, 2, 2)).astype(np.float32))
    bn.train()(x)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError):
        bn(torch.zeros(1, 3))
