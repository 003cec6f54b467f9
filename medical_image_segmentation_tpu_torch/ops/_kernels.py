"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/<name>-<hash>.so``, keyed by a hash of the source and the
flags, and loaded with ``ctypes``: seconds per build, against minutes for a
source that includes PyTorch's headers. A build or load failure raises;
nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures per source, function -> (restype, argtypes). Every pointer and
# the stream are c_void_p, or ctypes would pass them as 32-bit ints.
SIGNATURES = {
    "two_view_augment": {
        # img, params, out1, out2, B, H, W, C, OH, OW, in_u16, out_bf16,
        # vmax, mean[3], std[3], stream
        "mis_two_view_augment": (_I32, [_PTR] * 4 + [_I32] * 8 + [_F32] * 7 + [_PTR]),
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_kernel(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists; return
    the path of the shared library. The compiler's report (registers,
    spills) is kept beside it as ``.log``."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (once per source) and load ``csrc/<name>.cu``, with its C
    signatures declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_kernel(name))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
        return lib
