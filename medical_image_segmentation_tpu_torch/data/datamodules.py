"""SSL and segmentation datamodule registry over the shared MIS loaders.

Port of ``data/datamodules.py:40-276``. The JAX module cannot
be imported here: it pulls in JAX through ``ops/augment.py``. The stores,
the C++ decode ``Loader`` and the ``Registry`` are the JAX package's own,
imported as they are. Store paths come from the same environment variables,
stats and crop sizes are the same constants, and ``view_configs`` scales
the canonical views to the store's bit depth in the same way.

Radiology datamodules stay 1-channel end to end; CIFAR/ImageNet are RGB.
The four Decathlon datamodules serve paired image/mask batches from the
paired raw stores (``PairedLoader``) or a PNG directory
(``DecathlonLoader``), both the JAX package's own host code.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from medical_image_segmentation_tpu.core.registry import Registry
from medical_image_segmentation_tpu.data.decathlon import DecathlonDataset, DecathlonLoader
from medical_image_segmentation_tpu.data.loader import RANDOM, SEQUENTIAL, Loader, PairedLoader
from medical_image_segmentation_tpu_torch.ops.augment import (
    BYOL_TV_VIEW1, BYOL_TV_VIEW2, BYOL_VIEW1, BYOL_VIEW2, ViewConfig,
)

DATAMODULES: Registry = Registry("datamodule")


def get_datamodule(name: str):
    return DATAMODULES.get(name)


@dataclasses.dataclass
class SSLDataModule:
    """Two-view SSL datamodule backed by MIS stores."""

    NUM_CLASSES: int = 10
    channels: int = 1
    crop_size: int = 112
    low_res: bool = False
    has_train_labels: bool = True   # False: the probe gets no CE during pretraining
    # normalization stats on the stored value scale (0-255, or 0-65535 for u16)
    train_mean: Tuple[float, ...] = (57.9764,)
    train_std: Tuple[float, ...] = (60.4759,)
    val_mean: Tuple[float, ...] = (126.57,)
    val_std: Tuple[float, ...] = (63.46,)
    train_store: Optional[str] = None
    val_store: Optional[str] = None
    aug_recipe: str = "ffcv"        # "ffcv" (no blur/jitter) | "torchvision"
    window_prob: float = 0.0        # random CT re-windowing (0 = reference parity)
    value_max: float = 255.0        # 255 for uint8 stores, 65535 for FLAG_U16

    def view_configs(self) -> Tuple[ViewConfig, ViewConfig]:
        if self.aug_recipe == "torchvision":
            v1, v2 = BYOL_TV_VIEW1, BYOL_TV_VIEW2
        elif self.aug_recipe == "ffcv":
            v1, v2 = BYOL_VIEW1, BYOL_VIEW2
        else:
            raise ValueError(f"unknown aug_recipe {self.aug_recipe!r} (ffcv|torchvision)")
        size = (self.crop_size, self.crop_size)
        s = self.value_max / 255.0

        def adapt(v: ViewConfig) -> ViewConfig:
            return dataclasses.replace(
                v, out_size=size, window_prob=self.window_prob,
                value_max=self.value_max,
                solarize_threshold=v.solarize_threshold * s,
                window_level_range=tuple(x * s for x in v.window_level_range),
                window_width_range=tuple(x * s for x in v.window_width_range),
            )

        return adapt(v1), adapt(v2)

    def train_loader(self, batch_size: int, num_threads: int = 8, seed: int = 0) -> Loader:
        if not self.train_store or not os.path.exists(self.train_store):
            raise FileNotFoundError(f"train store not found: {self.train_store!r}")
        return Loader(self.train_store, batch_size, order=RANDOM,
                      num_threads=num_threads, seed=seed, drop_last=True)

    def val_loader(self, batch_size: int, num_threads: int = 8) -> Loader:
        if not self.val_store or not os.path.exists(self.val_store):
            raise FileNotFoundError(f"val store not found: {self.val_store!r}")
        return Loader(self.val_store, batch_size, order=SEQUENTIAL,
                      num_threads=num_threads, drop_last=False)


@DATAMODULES.register("RADIOLOGY_1M")
class Radiology1MDataModule(SSLDataModule):
    """Curated 1M TCIA subset: crop 112², unlabeled train store, NIH
    chest-x-ray val store with 10 classes."""

    def __init__(self, **kw):
        kw.setdefault("has_train_labels", False)
        kw.setdefault("train_store", os.environ.get("RADIOLOGY_1M_TRAIN_STORE", "data/stores/radiology_1M_train.mis"))
        kw.setdefault("val_store", os.environ.get("RADIOLOGY_1M_VAL_STORE", "data/stores/nih_chest_xray_test.mis"))
        super().__init__(**kw)


@DATAMODULES.register("RADIOLOGY_1M_U16")
class Radiology1MU16DataModule(SSLDataModule):
    """16-bit (HU-native) TCIA subset over a FLAG_U16 store; stats are the
    8-bit constants ×257."""

    def __init__(self, **kw):
        kw.setdefault("has_train_labels", False)
        kw.setdefault("value_max", 65535.0)
        kw.setdefault("train_mean", (57.9764 * 257.0,))
        kw.setdefault("train_std", (60.4759 * 257.0,))
        kw.setdefault("val_mean", (126.57 * 257.0,))
        kw.setdefault("val_std", (63.46 * 257.0,))
        kw.setdefault("train_store", os.environ.get("RADIOLOGY_1M_U16_TRAIN_STORE",
                                          "data/stores/radiology_1M_u16_train.mis"))
        kw.setdefault("val_store", os.environ.get("RADIOLOGY_1M_U16_VAL_STORE",
                                        "data/stores/nih_chest_xray_u16_test.mis"))
        super().__init__(**kw)


@DATAMODULES.register("CIFAR10")
class Cifar10DataModule(SSLDataModule):
    def __init__(self, **kw):
        kw.setdefault("NUM_CLASSES", 10)
        kw.setdefault("channels", 3)
        kw.setdefault("crop_size", 32)
        kw.setdefault("low_res", True)
        kw.setdefault("train_mean", (0.491 * 255, 0.482 * 255, 0.447 * 255))
        kw.setdefault("train_std", (0.247 * 255, 0.243 * 255, 0.261 * 255))
        kw.setdefault("val_mean", (0.491 * 255, 0.482 * 255, 0.447 * 255))
        kw.setdefault("val_std", (0.247 * 255, 0.243 * 255, 0.261 * 255))
        kw.setdefault("train_store", os.environ.get("CIFAR10_TRAIN_STORE", "data/stores/cifar10_train.mis"))
        kw.setdefault("val_store", os.environ.get("CIFAR10_VAL_STORE", "data/stores/cifar10_test.mis"))
        super().__init__(**kw)


@DATAMODULES.register("CIFAR100")
class Cifar100DataModule(SSLDataModule):
    def __init__(self, **kw):
        kw.setdefault("NUM_CLASSES", 100)
        kw.setdefault("channels", 3)
        kw.setdefault("crop_size", 32)
        kw.setdefault("low_res", True)
        kw.setdefault("train_mean", (0.507 * 255, 0.487 * 255, 0.441 * 255))
        kw.setdefault("train_std", (0.268 * 255, 0.257 * 255, 0.276 * 255))
        kw.setdefault("val_mean", (0.507 * 255, 0.487 * 255, 0.441 * 255))
        kw.setdefault("val_std", (0.268 * 255, 0.257 * 255, 0.276 * 255))
        kw.setdefault("train_store", os.environ.get("CIFAR100_TRAIN_STORE", "data/stores/cifar100_train.mis"))
        kw.setdefault("val_store", os.environ.get("CIFAR100_VAL_STORE", "data/stores/cifar100_test.mis"))
        super().__init__(**kw)


@DATAMODULES.register("IMAGENET")
class ImagenetDataModule(SSLDataModule):
    def __init__(self, **kw):
        kw.setdefault("NUM_CLASSES", 1000)
        kw.setdefault("channels", 3)
        kw.setdefault("crop_size", 112)
        kw.setdefault("train_mean", (123.675, 116.28, 103.53))
        kw.setdefault("train_std", (58.395, 57.12, 57.375))
        kw.setdefault("val_mean", (123.675, 116.28, 103.53))
        kw.setdefault("val_std", (58.395, 57.12, 57.375))
        kw.setdefault("train_store", os.environ.get("IMAGENET_TRAIN_STORE", "data/stores/imagenet_train.mis"))
        kw.setdefault("val_store", os.environ.get("IMAGENET_VAL_STORE", "data/stores/imagenet_val.mis"))
        super().__init__(**kw)


@dataclasses.dataclass
class DecathlonDataModule:
    """Paired image/mask datamodule: resize 224², stats on the 0-1 scale
    (``data/datamodules.py:216-257``). ``store_prefix`` selects the paired
    stores ``<prefix>_<split>_{images,masks}.mis`` where both exist."""

    images_dir: str = ""
    masks_dir: str = ""
    split_file: str = ""
    image_size: int = 224
    mean: Tuple[float, ...] = (0.5,)
    std: Tuple[float, ...] = (0.5,)
    store_prefix: str = ""

    def dataset(self, split: str) -> DecathlonDataset:
        return DecathlonDataset(self.images_dir, self.masks_dir, self.split_file, split)

    def loader(self, split: str, batch_size: int, seed: int = 0,
               shard: Tuple[int, int] = (0, 1), num_threads: int = 4):
        if self.store_prefix:
            img_store = f"{self.store_prefix}_{split}_images.mis"
            msk_store = f"{self.store_prefix}_{split}_masks.mis"
            if os.path.exists(img_store) and os.path.exists(msk_store):
                return PairedLoader(img_store, msk_store, batch_size,
                                    order=RANDOM if split == "train" else SEQUENTIAL,
                                    num_threads=num_threads, seed=seed,
                                    drop_last=(split == "train"), shard=shard)
        return DecathlonLoader(self.dataset(split), batch_size, image_size=self.image_size,
                               shuffle=(split == "train"), seed=seed, shard=shard, num_threads=num_threads)


def _decathlon(name: str, mean: Tuple[float, ...], std: Tuple[float, ...]):
    @DATAMODULES.register(name)
    class _M(DecathlonDataModule):
        def __init__(self, **kw):
            kw.setdefault("mean", mean)
            kw.setdefault("std", std)
            super().__init__(**kw)

    _M.__name__ = _M.__qualname__ = name
    return _M


# stats of the reference's lightning_module.py:727-728,749-750,771-772,793-794
DecathlonHeartDataModule = _decathlon("DECATHLON_HEART", (0.1181,), (0.1720,))
DecathlonLiverDataModule = _decathlon("DECATHLON_LIVER", (0.2089,), (0.2109,))
DecathlonHippocampusDataModule = _decathlon("DECATHLON_HIPPOCAMPUS", (0.4982,), (0.2373,))
DecathlonLungDataModule = _decathlon("DECATHLON_LUNG", (0.1475,), (0.1685,))
