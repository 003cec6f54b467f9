"""Multiprocess map harness for the offline ingest stage.

Parity with the reference harness
(`medical_image_segmentation/analyze_data/utils.py`):

- ``get_file_paths``: recursive walk filtered by extension (:18-46);
- ``get_file_type_counts``: extension histogram (:49-64);
- ``process_files``: ProcessPoolExecutor fan-out with progress reporting,
  cancel-all-futures on first worker error (:67-129);
- ``start_orphan_checker``: daemon thread in each worker that hard-exits
  when the parent dies, so a killed parent can't leak workers (:132-139).

Differences: progress uses ``rich`` when attached to a tty, plain stderr
counters otherwise (SLURM logs).

The port's copy starts its workers with ``spawn``, not the platform's
``fork``: a caller may already hold CUDA and threads (``chip_smoke.py``
runs the ingest stages after the trainers), and a forked child of such a
process must not run. Workers import the mapped function by its module
path, so it must be a module-level function or a ``partial`` of one.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import threading
import time
from concurrent.futures import FIRST_EXCEPTION, ProcessPoolExecutor, wait
from typing import Callable, Dict, Iterable, List, Optional, Sequence


def get_file_paths(directories: Sequence[str], extensions: Optional[Sequence[str]] = None) -> List[str]:
    """Recursively collect file paths under ``directories`` whose suffix is in
    ``extensions`` (e.g. ``[".dcm"]``). ``None`` collects everything."""
    exts = tuple(e.lower() for e in extensions) if extensions else None
    out: List[str] = []
    for d in directories:
        for root, _dirs, files in os.walk(d):
            for name in files:
                if exts is None or name.lower().endswith(exts):
                    out.append(os.path.join(root, name))
    return out


def get_file_type_counts(directories: Sequence[str]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for p in get_file_paths(directories):
        ext = os.path.splitext(p)[1].lower()
        counts[ext] = counts.get(ext, 0) + 1
    return counts


def start_orphan_checker(poll_seconds: float = 1.0) -> None:
    """In a worker: exit hard if the parent process dies (reference
    `utils.py:132-139`)."""
    parent = os.getppid()

    def check():
        while True:
            if os.getppid() != parent:
                os._exit(-1)
            time.sleep(poll_seconds)

    threading.Thread(target=check, daemon=True).start()


def _init_worker():
    start_orphan_checker()


def process_files(
    paths: Iterable[str],
    fn: Callable[[str], dict],
    num_processes: int,
    chunk_size: int = 256,
    progress_label: str = "processing",
    quiet: bool = False,
) -> Dict[str, dict]:
    """Map ``fn`` over ``paths`` with a process pool.

    Returns ``{path: fn(path)}`` in the order of ``paths``. Raises
    ``ValueError`` for ``num_processes < 1`` (reference `utils.py:67-129`
    contract). On the first worker exception, all outstanding futures are
    cancelled and the exception re-raised.

    The reference returns the workers' completion order, and
    ``create_subset``'s dedup keeps the first path of each hash in that
    order, so which duplicate survives varied from run to run; the port's
    input order makes it the first path scanned.
    """
    paths = list(paths)
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")

    results: Dict[str, dict] = {}
    done_count = 0
    t0 = time.time()

    def report():
        if quiet or not paths:
            return
        rate = done_count / max(time.time() - t0, 1e-9)
        print(
            f"\r{progress_label}: {done_count}/{len(paths)} ({rate:.0f}/s)",
            end="" if done_count < len(paths) else "\n",
            file=sys.stderr,
        )

    if num_processes == 1:
        for p in paths:
            results[p] = fn(p)
            done_count += 1
            if done_count % chunk_size == 0 or done_count == len(paths):
                report()
        return results

    with ProcessPoolExecutor(max_workers=num_processes, initializer=_init_worker,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {pool.submit(fn, p): p for p in paths}
        pending = set(futures)
        try:
            while pending:
                done, pending = wait(pending, timeout=5.0, return_when=FIRST_EXCEPTION)
                for fut in done:
                    exc = fut.exception()
                    if exc is not None:
                        for other in pending:
                            other.cancel()
                        raise exc
                    results[futures[fut]] = fut.result()
                    done_count += 1
                report()
        except BaseException:
            for fut in pending:
                fut.cancel()
            raise
    return {p: results[p] for p in paths}  # input order, whatever order the workers finished in
