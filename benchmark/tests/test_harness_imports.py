"""What a run loads: nothing of JAX or the JAX package, and a reference
that loads nothing of the program."""

import ast
import glob
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import run as bench_run
from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "medical_image_segmentation_tpu"}
PROGRAM = "medical_image_segmentation_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(spec.BENCH_DIR, "**", "*.py"), recursive=True)))
def test_no_source_imports_jax_or_the_old_bench(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & (FORBIDDEN | {"bench_torch", "chip_smoke", "tools", "bench"}), path
    if os.sep + "reference" + os.sep in path:
        assert PROGRAM not in tops, path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "medical_image_segmentation_tpu_torch_extra", types.ModuleType("x"))
    assert "medical_image_segmentation_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert bench_run.forbidden_modules() == ["jax"]


def _python(code, cwd):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": spec.ROOT})


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from _bench_tiny import run_tiny\n"
        "assert run_tiny('byol_r18.device')['correct']\n"
        "assert run_tiny('unet_r18.serve')['correct']\n"
        "from benchmark import run\n"
        "print(run.forbidden_modules())\n")
    out = _python(code, spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, json, torch\n"
        "from benchmark.reference import augment, byol, layouts, nets\n"
        "from benchmark.harness.weights import make_weights\n"
        "cfg = json.load(open('benchmark/configs/byol_r18.json'))\n"
        "cfg.update(batch_per_chip=4, hidden_dim=32, proj_dim=8)\n"
        "on, tg = layouts.byol_layouts(cfg)\n"
        "w = make_weights(on, 1, 'cpu')\n"
        "ref = byol.ReferenceBYOL(cfg, w, {k: w['encoder.' + k] for k in tg}, cfg['start_step'])\n"
        "ref.train_step(torch.randn(4, 32, 32, 1), torch.randn(4, 32, 32, 1))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'medical_image_segmentation_tpu_torch', "
        "'medical_image_segmentation_tpu', 'jax'}))\n")
    out = _python(code, spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("alone", [False, True])
def test_a_run_without_a_card_or_the_program_prints_no_result(tmp_path, alone):
    cwd = spec.ROOT
    if alone:  # a directory with only BENCHMARK.json and the files under paths
        cwd = str(tmp_path)
        shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), cwd)
        shutil.copytree(spec.BENCH_DIR, os.path.join(cwd, "benchmark"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "byol_r18.device", "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                         text=True, timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
