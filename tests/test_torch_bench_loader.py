"""``tools/bench_loader_torch.py`` on toy stores, and the native library's
cache name.

The loader benchmark runs in-process on a 32-image store of each codec,
native at 1 and 2 threads beside the Python ``StoreReader``, and once in
``--views`` mode; its last line carries ``tools/bench_loader.py``'s fields
plus ``reader`` and ``python_images_per_sec``. The shared object's name is
a digest of the sources, the build command and the host CPU's model
(``-march=native``), so a cache shared by machines with other CPUs keeps a
library for each.
"""

import importlib.util
import json
import os

import pytest

from medical_image_segmentation_tpu_torch.data.store import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "bench_loader_torch.py")
TOY = ["--n_images", "32", "--image_size", "64", "--batch_size", "8", "--threads", "1", "2"]
FIELDS = ["metric", "value", "unit", "images_per_sec", "codec", "bit_depth", "host_cpus", "views",
          "reader", "python_images_per_sec"]


def load_tool():
    spec = importlib.util.spec_from_file_location("bench_loader_torch", TOOL)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def run_tool(argv, capsys):
    rc = load_tool().main(argv)
    captured = capsys.readouterr()
    return rc, json.loads(captured.out.strip().splitlines()[-1]), captured.err


@pytest.mark.parametrize("codec,bits,views", [
    ("raw", 8, 0), ("jpeg", 8, 0), ("png", 8, 0), ("jls", 8, 0), ("png", 16, 0), ("jpeg", 8, 2),
])
def test_bench_loader_line(codec, bits, views, capsys):
    rc, line, err = run_tool(TOY + ["--codec", codec, "--bit_depth", str(bits), "--views", str(views)], capsys)
    assert rc == 0
    missing = [k for k in FIELDS if k not in line]
    assert not missing, missing
    assert line["metric"] == "loader_decoded_gbytes_per_sec" and line["unit"] == "GB/s"
    assert (line["codec"], line["bit_depth"], line["views"]) == (codec, bits, views)
    assert line["reader"] == "native" and line["host_cpus"] == os.cpu_count()
    assert set(line["images_per_sec_by_threads"]) == {"1", "2"}
    assert line["images_per_sec"] == max(line["images_per_sec_by_threads"].values())
    assert line["value"] == pytest.approx(line["images_per_sec"] * 64 * 64 * bits // 8 / 1e9, abs=1e-3)
    assert line["python_images_per_sec"] > 0
    assert f"synthetic {codec} store" in err and "python StoreReader, 1 thread" in err


def test_bench_loader_reads_a_given_store(tmp_path, capsys):
    tool = load_tool()
    path = str(tmp_path / "given.mis")
    tool.write_synthetic_store(path, 16, 32, "raw", 8)
    rc, line, err = run_tool(["--store", path, "--batch_size", "4", "--threads", "1"], capsys)
    assert rc == 0 and line["codec"] == "raw"  # the store's, not the flag's default
    assert "synthetic" not in err and os.path.exists(path)


def test_bench_loader_fails_without_the_native_library(monkeypatch, capsys):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert load_tool().main(TOY + ["--codec", "raw", "--n_images", "8"]) == 1
    captured = capsys.readouterr()
    assert "does not fall back" in captured.err and not captured.out


def test_rrc_params_lie_inside_the_image():
    import numpy as np

    p = load_tool().rrc_params(np.random.default_rng(0), 64, 3, 40, 50)
    y0, x0, ch, cw, flip = np.moveaxis(p, -1, 0)
    assert p.shape == (64, 3, 5) and p.dtype == np.float32
    assert (ch >= 1).all() and (cw >= 1).all() and (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + ch <= 40 + 1e-4).all() and (x0 + cw <= 50 + 1e-4).all()
    assert set(np.unique(flip)) <= {0.0, 1.0}


def test_library_name_changes_with_the_command():
    command = native.build_command("")[:-2]
    assert native.library_name() == native.library_name(command=command)
    assert native.library_name(command=command) == native.library_name(command=list(command))
    other = [a if a != "-march=native" else "-march=x86-64" for a in command]
    assert native.library_name(command=other) != native.library_name(command=command)
    assert native.library_name(command=command + ["-g"]) != native.library_name(command=command)


def test_library_name_changes_with_the_cpu_model():
    here = native.host_cpu_model()
    assert here
    assert native.library_name(cpu_model=here) == native.library_name()
    assert native.library_name(cpu_model="AMD EPYC 9654 96-Core Processor") != native.library_name()
    assert (native.library_name(cpu_model="AMD EPYC 9654 96-Core Processor")
            == native.library_name(cpu_model="AMD EPYC 9654 96-Core Processor"))


def test_library_name_ignores_where_the_checkout_is(tmp_path, monkeypatch):
    """Sources are named relative to csrc/ in the digest: the same sources,
    command and CPU give the same name from a checkout elsewhere."""
    import shutil

    here = native.library_name()
    csrc = tmp_path / "elsewhere" / "csrc"
    shutil.copytree(native.CSRC_DIR, csrc)
    monkeypatch.setattr(native, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(native, "_SRCS", [str(csrc / os.path.basename(p)) for p in native._SRCS])
    monkeypatch.setattr(native, "_HEADERS", [str(csrc / os.path.basename(p)) for p in native._HEADERS])
    assert any(a.startswith(str(csrc)) for a in native.build_command("x"))
    assert native.library_name() == here
    with open(native._SRCS[0], "ab") as f:
        f.write(b"\n")
    assert native.library_name() != here


def test_build_publishes_under_the_library_name(tmp_path, monkeypatch):
    """``_build`` looks for, and writes, ``library_name()`` in the cache:
    a library already there is reused without a compiler."""
    monkeypatch.setenv("MIS_NATIVE_CACHE", str(tmp_path))
    monkeypatch.setattr(native, "_BUILD", {})
    (tmp_path / native.library_name()).write_bytes(b"")
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: pytest.fail("built again"))
    assert native._build() == str(tmp_path / native.library_name())
    assert native.build_info()["seconds"] is None
