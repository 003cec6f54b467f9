"""The port's public surface against the JAX package's.

Every public module-level name of every module of the JAX package (a
function, class or assignment at the top of the file whose name does not
start with ``_``) has a counterpart at the same path in the port, defined
or imported there, apart from the JAX idioms listed below, which have no
use in torch. ``register_datamodule`` and ``print_batch_stats``, the last
two plain helpers ported, are held against the JAX functions.
"""

import ast
import io
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "medical_image_segmentation_tpu")
PORT_PKG = os.path.join(ROOT, "medical_image_segmentation_tpu_torch")

# modules of the JAX package that are TPU machinery (ROADMAP "Not to port")
NOT_PORTED = {"core/device_probe.py"}
# the Pallas kernel's module → its port, with the names that changed
RENAMED = {"ops/pallas_augment.py": ("ops/fused_augment.py", {
    "pallas_two_view_augment": "fused_two_view_augment", "pallas_supported": "fused_supported"})}
# JAX idioms with no use in torch: pytrees of state, shardings, optax's LARS,
# the flax ResNet builders, orbax restore and XLA's memory analysis
JAX_ONLY = {
    "train/byol_task.py": {"BYOLState"},
    "train/segmentation_task.py": {"SegState"},
    "train/seg3d_task.py": {"Seg3DState"},
    "eval/linear_probe.py": {"ProbeState"},
    "parallel/mesh.py": {"data_sharding", "replicated", "shard_batch", "spatial_sharding"},
    "parallel/tp.py": {"byol_tp_shardings"},
    "ops/lars.py": {"lars", "scale_by_lars", "LarsState", "make_lars_mask"},
    "models/resnet.py": {"make_resnet", "conv_kernel_init", "ModuleDef"},
    "core/checkpoint.py": {"restore_checkpoint"},
    "core/hbm.py": {"hbm_report", "memory_analysis_of"},
    "data/loader.py": {"device_put_sharded_batches"},
}


def module_names(path, with_imports=False):
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                out.update(e.id for e in ast.walk(target) if isinstance(e, ast.Name))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


def jax_modules():
    for root, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(root, f), JAX_PKG).replace(os.sep, "/")
            if f.endswith(".py") and rel not in NOT_PORTED:
                yield rel


@pytest.mark.parametrize("rel", sorted(jax_modules()))
def test_every_public_name_has_a_counterpart(rel):
    port_rel, renames = RENAMED.get(rel, (rel, {}))
    port = os.path.join(PORT_PKG, port_rel)
    assert os.path.exists(port), f"no {port_rel} in the port"
    wanted = {renames.get(n, n) for n in module_names(os.path.join(JAX_PKG, rel))}
    have = module_names(port, with_imports=True)
    jax_only = JAX_ONLY.get(rel, set())
    assert not jax_only & have, f"listed as JAX-only but present: {sorted(jax_only & have)}"
    missing = wanted - have - jax_only
    assert not missing, f"{port_rel} lacks {sorted(missing)}"


def test_jax_only_list_names_real_jax_names_and_no_helper():
    listed = set().union(*JAX_ONLY.values())
    assert not listed & {"register_datamodule", "print_batch_stats"}
    for rel, names in JAX_ONLY.items():
        assert names <= module_names(os.path.join(JAX_PKG, rel)), rel


def test_register_datamodule_returns_the_class_from_get_datamodule():
    from medical_image_segmentation_tpu.data import datamodules as jax_dm
    from medical_image_segmentation_tpu_torch.data import datamodules as dm

    @dm.register_datamodule("TEST_PUBLIC_NAMES_DM")
    class Toy(dm.SSLDataModule):
        pass

    try:
        assert dm.get_datamodule("TEST_PUBLIC_NAMES_DM") is Toy
        assert "TEST_PUBLIC_NAMES_DM" in dm.DATAMODULES
        with pytest.raises(KeyError, match="already registered"):
            dm.register_datamodule("TEST_PUBLIC_NAMES_DM")(Toy)
        # the reference's registry is its own
        assert "TEST_PUBLIC_NAMES_DM" not in jax_dm.DATAMODULES
    finally:
        dm.DATAMODULES._items.pop("TEST_PUBLIC_NAMES_DM", None)


@pytest.mark.parametrize("arr", [
    np.arange(24, dtype=np.uint8).reshape(2, 3, 4, 1),
    np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32),
    np.array([[-1.5, 2.25], [0.0, 7.0]]),
])
def test_print_batch_stats_writes_the_jax_text(arr):
    from medical_image_segmentation_tpu.utils.viz import print_batch_stats as jax_stats
    from medical_image_segmentation_tpu_torch.utils.viz import print_batch_stats

    want, got = io.StringIO(), io.StringIO()
    jax_stats("images", arr, file=want)
    print_batch_stats("images", arr, file=got)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().startswith(f"images: shape={arr.shape} dtype={arr.dtype} ")
