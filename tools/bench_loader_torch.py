"""Host-loader throughput benchmark of the port's store readers. Port of
``tools/bench_loader.py``.

    python tools/bench_loader_torch.py [--codec jpeg|png|raw|jls] [--threads 1 2 4 8] [--views V]

Measures the port's native MIS-store decode path in isolation
(``medical_image_segmentation_tpu_torch/data/store/native.py``, built from
the port's own ``csrc/`` with ``g++`` alone): mmap + JPEG/PNG/JPEG-LS/raw
decode into batch buffers, per thread count, reporting images/s and GB/s
of decoded pixels. ``--views V`` measures the crop-at-decode path instead
(``fetch_views``: V RandomResizedCrop windows per image). Beside it, the
same batches through the port's Python ``StoreReader`` on one thread
(``fetch_views_fallback`` for views): the native/Python ratio. The native
library must build: the tool fails rather than fall back.

The line names the store's codec (of its first record). Without
``--store`` it writes a synthetic store of CT-like content (smooth
structure and noise: entropy codecs are content-sensitive and medical
frames are smooth) with the port's writer into a temporary directory.
The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Throughput of the port's store readers.")
    ap.add_argument("--store", default=None, help="existing store (default: synthesize one)")
    ap.add_argument("--n_images", type=int, default=2048)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--codec", default="jpeg", choices=["jpeg", "png", "raw", "jls"])
    ap.add_argument("--bit_depth", type=int, default=8, choices=(8, 16),
                    help="16 = FLAG_U16 store (HU-native; codecs raw/png/jls)")
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--views", type=int, default=0,
                    help=">0: fetch_views mode — sample V RandomResizedCrop "
                         "windows per image (BYOL scale 0.08-1.0) and measure "
                         "the crop-at-decode path (windowed JPEG; row-limited "
                         "JLS) instead of full-frame decode")
    ap.add_argument("--crop_size", type=int, default=112,
                    help="view size for --views mode")
    return ap.parse_args(argv)


def codecs() -> dict:
    """Codec name → the store's codec number."""
    from medical_image_segmentation_tpu_torch.data.store import CODEC_JLS, CODEC_JPEG, CODEC_PNG, CODEC_RAW

    return {"jpeg": CODEC_JPEG, "png": CODEC_PNG, "raw": CODEC_RAW, "jls": CODEC_JLS}


def write_synthetic_store(path: str, n: int, size: int, codec_name: str, bit_depth: int) -> None:
    """``n`` CT-like ``size``² single-channel images from seed 0."""
    from medical_image_segmentation_tpu_torch.data.store import StoreWriter

    codec = codecs()[codec_name]
    rng = np.random.default_rng(0)
    dtype = np.uint16 if bit_depth == 16 else np.uint8
    hi = 65536 if bit_depth == 16 else 256
    y, x = np.mgrid[0:size, 0:size]
    base = 0.3 + 0.25 * np.sin(y / 30.0) * np.cos(x / 25.0)
    with StoreWriter(path, channels=1, dtype=dtype) as w:
        for _ in range(n):
            img = np.clip(base + rng.normal(0, 0.01, base.shape), 0, 1)
            w.add((img * (hi - 1)).astype(dtype)[..., None], codec=codec)


def rrc_params(rng, b: int, views: int, h: int, w: int) -> np.ndarray:
    """BYOL RandomResizedCrop windows (area U(0.08,1)·HW, log-ratio
    U(3/4,4/3)) as the (B, V, 5) float32 (y0, x0, ch, cw, flip) array
    ``fetch_views`` takes."""
    area = h * w * rng.uniform(0.08, 1.0, (b, views))
    aspect = np.exp(rng.uniform(np.log(0.75), np.log(4 / 3), (b, views)))
    cw_ = np.clip(np.sqrt(area * aspect), 1.0, w)
    ch_ = np.clip(np.sqrt(area / aspect), 1.0, h)
    y0 = rng.uniform(0, 1, ch_.shape) * (h - ch_)
    x0 = rng.uniform(0, 1, cw_.shape) * (w - cw_)
    flip = (rng.uniform(0, 1, cw_.shape) < 0.5).astype(np.float32)
    return np.stack([y0, x0, ch_, cw_, flip], axis=-1).astype(np.float32)


def main(argv=None) -> int:
    args = parse_args(argv)
    from medical_image_segmentation_tpu_torch.data.host_precrop import fetch_views_fallback
    from medical_image_segmentation_tpu_torch.data.store import StoreReader
    from medical_image_segmentation_tpu_torch.data.store import native

    tmp = None
    try:
        store_path = args.store
        if store_path is None:
            tmp = tempfile.mkdtemp()
            store_path = os.path.join(tmp, "bench.mis")
            write_synthetic_store(store_path, args.n_images, args.image_size, args.codec, args.bit_depth)
            print(f"synthetic {args.codec} store: {os.path.getsize(store_path)/1e6:.1f} MB", file=sys.stderr)
        if native.get_lib() is None:
            print("bench_loader_torch: the port's native store reader did not build (see the compiler's "
                  "output above); this tool measures it and does not fall back", file=sys.stderr)
            return 1
        ns = native.NativeStore(store_path)
        reader = StoreReader(store_path)
        try:
            n = ns.num_samples
            h, w, c = ns.shape
            bytes_per_img = h * w * c * ns.dtype.itemsize
            batches = [b for b in np.split(np.random.default_rng(1).permutation(n).astype(np.int64),
                                           range(args.batch_size, n, args.batch_size))
                       if len(b) == args.batch_size]
            prng = np.random.default_rng(2)
            params = [rrc_params(prng, len(b), args.views, h, w) if args.views else None for b in batches]
            out_hw = (args.crop_size, args.crop_size)
            done = len(batches) * args.batch_size

            def run(fetch) -> float:
                t0 = time.perf_counter()
                for batch, p in zip(batches, params):
                    fetch(batch, p)
                return done / (time.perf_counter() - t0)

            def python_fetch(batch, p):
                if args.views:
                    return fetch_views_fallback(reader, batch, p, out_hw)
                out = np.empty((len(batch), h, w, c), ns.dtype)
                for j, i in enumerate(batch):
                    out[j] = reader[int(i)][0]
                return out

            mode = f" ({args.views} RRC views/img)" if args.views else ""
            results = {}
            for t in args.threads:
                def native_fetch(batch, p, t=t):
                    if args.views:
                        return ns.fetch_views(batch, p, out_hw=out_hw, num_threads=t)
                    return ns.fetch(batch, num_threads=t)

                ips = run(native_fetch)
                results[t] = (ips, ips * bytes_per_img / 1e9)
                print(f"threads={t}: {ips:.0f} img/s, {results[t][1]:.3f} GB/s decoded{mode}", file=sys.stderr)
            py_ips = run(python_fetch)
            print(f"python StoreReader, 1 thread: {py_ips:.0f} img/s{mode}", file=sys.stderr)
            bit_depth = 16 if ns.dtype == np.uint16 else 8
            codec = {v: k for k, v in codecs().items()}[reader.record(0).codec]
        finally:
            ns.close()
            reader.close()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    best_t = max(results, key=lambda t: results[t])
    best = results[best_t]
    print(json.dumps({
        "metric": "loader_decoded_gbytes_per_sec",
        "value": round(best[1], 3),
        "unit": "GB/s",
        "images_per_sec": round(best[0], 1),
        "threads": best_t,
        "images_per_sec_by_threads": {str(t): round(r[0], 1) for t, r in results.items()},
        "python_images_per_sec": round(py_ips, 1),
        "reader": "native",
        "codec": codec,
        "bit_depth": bit_depth,
        "host_cpus": os.cpu_count(),
        "views": args.views,
    }))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    raise SystemExit(main())
