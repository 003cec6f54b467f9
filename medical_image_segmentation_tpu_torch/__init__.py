"""medical_image_segmentation_tpu_torch — the PyTorch/CUDA port of
``medical_image_segmentation_tpu``, written for one NVIDIA H100.

The JAX package stays the reference; every module here names the JAX
function it ports, and ``tests/test_torch_*.py`` hold each one against it
on the CPU. This package imports ``torch`` and never ``jax``. Host code that
never touched JAX (the MIS store, the C++ decode ``Loader``, the registry,
the CSV logger) is imported from the JAX package as it is.

Layers (bottom-up):
  csrc/     hand-written Hopper kernels (CUDA C++, plain C interface).
  ops/      two-view augmentation (plain torch + the fused kernel's
            wrapper), BYOL loss, LARS, LR/EMA schedules.
  models/   ResNet family, MLP heads, BYOL network, flax-semantics BatchNorm.
  core/     flax → torch weight converter.
  data/     SSL datamodules over the shared Loader, pinned double-buffered
            host→device feed.
  train/    BYOL task and the ``mis-train-ssl-torch`` entry point.
"""

__version__ = "0.1.0"
