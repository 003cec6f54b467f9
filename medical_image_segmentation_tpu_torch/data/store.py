"""The MIS sample store, shared with the JAX package.

The store format, writer and reader are host code that never imported JAX;
the port uses them as they are, through this one module, so that scripts
built on the port (``chip_smoke.py``) import only the port.
"""

from medical_image_segmentation_tpu.data.store import CODEC_RAW, FLAG_U16, StoreReader, StoreWriter

__all__ = ["CODEC_RAW", "FLAG_U16", "StoreReader", "StoreWriter"]
