"""medical_image_segmentation_tpu_torch — the PyTorch/CUDA port of
``medical_image_segmentation_tpu``, written for one NVIDIA H100.

The JAX package stays the reference; every module here names the JAX
function it ports, and ``tests/test_torch_*.py`` hold each one against it
on the CPU. This package imports ``torch`` and never ``jax``. Host code that
never touched JAX (the MIS store, the C++ decode ``Loader``, the registry,
the CSV logger) is imported from the JAX package as it is.

Layers (bottom-up):
  csrc/     hand-written Hopper kernels (CUDA C++, plain C interface).
  ops/      two-view and paired segmentation augmentation (plain torch +
            the fused kernel's wrapper), BYOL loss, Dice/IoU, LARS, LR/EMA
            schedules.
  models/   ResNet family (with the skip pyramid), MLP heads, BYOL network,
            U-Net, flax-semantics BatchNorm.
  core/     flax → torch weight converter, torch checkpoints and the
            BYOL → U-Net encoder graft.
  data/     SSL and Decathlon datamodules over the shared loaders, pinned
            double-buffered host→device feed.
  eval/     2D sliding-window inference.
  utils/    PNG writer, overlay grid.
  serve.py  the serving function (uint8 batch → masks).
  train/    BYOL and segmentation tasks, preemption guard, and the
            ``mis-train-ssl-torch``, ``mis-train-segmentation-torch`` and
            ``mis-predict-torch`` entry points.
"""

__version__ = "0.1.0"
