"""``bench_torch.py``, the port's benchmark, on the CPU at toy widths.

Each task runs in-process through ``bench_torch.main(argv)`` with
``--device cpu``; its last line must carry ``bench.py``'s metric name and
fields (less ``vs_baseline``, plus the card's name and power limit). The
contention tripwire is held to ``bench.py``'s to the value, and the
volumetric window count to ``bench.py``'s inline count. A subprocess shows
that the new programs import no JAX. The CPU's numbers are no device
metric: these tests check what the program prints, not how fast it is.
"""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

TOY = ["--device", "cpu", "--steps", "2", "--warmup", "1"]
BYOL = TOY + ["--task", "byol", "--batch_size", "4", "--image_size", "64", "--crop_size", "32"]
SEG = TOY + ["--task", "seg", "--batch_size", "2", "--image_size", "64"]
VOL = ["--batch_size", "2", "--features3d", "8", "16", "--volume_size", "16", "32", "32", "--crop3d", "8", "16", "16"]
SEG3D = TOY + ["--task", "seg3d"] + VOL
PREDICT = TOY + ["--task", "predict", "--batch_size", "2", "--image_size", "64"]
PREDICT3D = TOY + ["--task", "predict3d"] + VOL
STORE = ["--store", "auto", "--store_images", "16"]

RUNS = {
    "byol": BYOL,
    "byol_store_raw": BYOL + STORE + ["--store_codec", "raw"],
    "byol_store_precrop": BYOL + STORE + ["--precrop"],
    "seg": SEG,
    "seg3d": SEG3D,
    "predict": PREDICT,
    "predict_exported": PREDICT + ["--exported"],
    "predict3d": PREDICT3D,
    "predict3d_sw_loop": PREDICT3D + ["--sw_loop"],
}
DISPERSION = ["step_ms_p50", "step_ms_p99", "step_ms_loop_mean"]
CARD = ["device_name", "power_limit_w", "gpus"]
# bench.py's fields of each task's line, less vs_baseline, plus the card's
KEYS = {
    "byol": ["metric", "value", "unit", "mode", "task", "mfu", *DISPERSION, *CARD],
    "seg": ["metric", "value", "unit", "task", "mfu", "image_size", *DISPERSION, *CARD],
    "seg3d": ["metric", "value", "unit", "task", "mfu", "features", *DISPERSION, *CARD],
    "predict": ["metric", "value", "unit", "task", "mfu", "image_size", "fp32", "batch_latency_ms_p50",
                "batch_latency_ms_p99", *CARD],
    "predict3d": ["metric", "value", "unit", "task", "mfu", "sw_mode", "volume", "window", "windows_per_volume",
                  "volume_latency_ms_p50", "volume_latency_ms_p99", *CARD],
}
STORE_KEYS = ["loader_gbytes_per_sec", "num_decode_threads", "precrop", "h2d_bytes_per_batch", "reader",
              "decode_ms_per_batch", "decode_batches_timed", "wait_ms_per_batch", "wait_batches_timed"]
EXPORTED_KEYS = ["exported_images_per_sec_per_chip", "exported_batch", "exported_latency_ms_p50",
                 "exported_latency_ms_p99"]
METRICS = {"byol": "aug_train_images_per_sec_per_chip", "seg": "seg_train_images_per_sec_per_chip",
           "seg3d": "seg3d_train_volumes_per_sec_per_chip", "predict": "predict_images_per_sec_per_chip",
           "predict3d": "predict3d_volumes_per_sec_per_chip"}

_CACHE = {}


def run_bench(name, capsys):
    """The return code, last JSON line and stderr of one run (once a process)."""
    if name not in _CACHE:
        rc = bench_torch.main(RUNS[name])
        captured = capsys.readouterr()
        _CACHE[name] = (rc, json.loads(captured.out.strip().splitlines()[-1]), captured.err)
    return _CACHE[name]


def load_bench_py():
    spec = importlib.util.spec_from_file_location("bench", BENCH_PY)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_metric_names_are_bench_py_s():
    names = set(re.findall(r'"metric": "(\w+)"', open(BENCH_PY).read()))
    assert names == set(METRICS.values())


@pytest.mark.parametrize("name", sorted(RUNS))
def test_task_prints_bench_py_s_line(name, capsys):
    rc, line, _ = run_bench(name, capsys)
    task = line["task"]
    assert rc == 0 and name.startswith(task)
    assert line["metric"] == METRICS[task]
    missing = [k for k in KEYS[task] if k not in line]
    assert not missing, missing
    assert "vs_baseline" not in line
    assert line["value"] > 0 and np.isfinite(line["value"])
    # the CPU is no card: no peak to hold FLOPs against, no power limit
    assert line["mfu"] is None and line["device_name"] == "cpu" and line["power_limit_w"] is None
    assert line["gpus"] == 0
    if "mode" in line:
        assert line["mode"] == ("store" if "store" in name else "device")
    if "step_ms_p50" in line:
        assert line["steps_run"] == 1 + 2 + 2 + 1  # warmup, timed, probe, the FLOP count's
        assert line["step_ms_p99"] >= line["step_ms_p50"] > 0


@pytest.mark.parametrize("name", ["byol_store_raw", "byol_store_precrop"])
def test_store_mode_reports_the_loader(name, capsys):
    _, line, err = run_bench(name, capsys)
    missing = [k for k in STORE_KEYS if k not in line]
    assert not missing, missing
    assert line["reader"] in ("native", "python")
    assert line["precrop"] == ("precrop" in name)
    # 2 crop² views a sample with --precrop, the stored frame else
    shipped = 2 * 32 * 32 if line["precrop"] else 64 * 64
    assert line["h2d_bytes_per_batch"] == 4 * shipped
    assert line["num_decode_threads"] == os.cpu_count()
    assert line["decode_batches_timed"] >= 1 + 2 + 2
    assert "synthetic" in err


def test_predict_exported_fields(capsys):
    _, line, err = run_bench("predict_exported", capsys)
    missing = [k for k in EXPORTED_KEYS if k not in line]
    assert not missing, missing
    assert line["exported_batch"] == 2 and line["exported_images_per_sec_per_chip"] > 0
    assert "torch.export.load" in err
    _, plain, _ = run_bench("predict", capsys)
    assert not set(EXPORTED_KEYS) & set(plain)


@pytest.mark.parametrize("name", ["predict3d", "predict3d_sw_loop"])
def test_predict3d_modes_and_window_count(name, capsys):
    _, line, _ = run_bench(name, capsys)
    assert line["sw_mode"] == ("loop" if "loop" in name else "fused")
    assert line["volume"] == [16, 32, 32] and line["window"] == [8, 16, 16]
    assert line["windows_per_volume"] == bench_py_window_count((16, 32, 32), (8, 16, 16)) == 27


def bench_py_window_count(vol, window):
    """``bench.py``'s inline windows-per-volume count (the ``n_win`` loop of
    ``_predict3d_bench``), run from its own source."""
    tree = ast.parse(open(BENCH_PY).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_predict3d_bench")
    start = next(i for i, n in enumerate(fn.body) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "n_win")
    loop = fn.body[start + 1]
    assert isinstance(loop, ast.For)
    ns = {"vol": tuple(vol), "window": tuple(window)}
    exec(compile(ast.Module(body=fn.body[start:start + 2], type_ignores=[]), BENCH_PY, "exec"), ns)
    return ns["n_win"]


@pytest.mark.parametrize("vol,window", [
    ((64, 96, 96), (32, 64, 64)),      # the bench's defaults
    ((16, 32, 32), (8, 16, 16)),
    ((20, 40, 33), (8, 16, 16)),       # strides that do not divide
    ((80, 160, 160), (32, 64, 64)),
    ((6, 12, 40), (8, 16, 16)),        # smaller than the window on two axes
])
def test_windows_per_volume_is_bench_py_s(vol, window):
    from medical_image_segmentation_tpu_torch.eval.sliding_window import count_windows_3d

    assert count_windows_3d(vol, window) == bench_py_window_count(vol, window)


R04 = [  # (probe latencies in s, loop mean in ms): tests/test_bench_dispersion.py's replays
    (np.full(12, 0.080), 78.0),
    (np.full(12, 0.078), 100.9),
    (np.array([0.078] * 11 + [0.155]), 80.0),
    (np.full(5, 0.010), 10.0),
]


def test_dispersion_fields_equal_bench_py_s(capsys):
    ref = load_bench_py()
    rng = np.random.default_rng(0)
    cases = R04 + [(rng.uniform(0.01, 0.2, rng.integers(1, 13)), float(rng.uniform(5, 250))) for _ in range(50)]
    flagged = 0
    for lat, loop_ms in cases:
        want = ref._dispersion_fields(lat, loop_ms, "byol")
        ref_err = capsys.readouterr().err
        got = bench_torch._dispersion_fields(lat, loop_ms, "byol")
        err = capsys.readouterr().err
        assert got == want
        assert err == ref_err.replace("TPU", "GPU")
        flagged += "contention_suspected" in got
    assert 0 < flagged < len(cases)


def test_contention_warning_names_the_gpu(capsys):
    f = bench_torch._dispersion_fields(np.full(12, 0.078), 100.9, "byol")
    err = capsys.readouterr().err
    assert f["contention_suspected"] is True
    assert "CONTENDED" in err and "GPU" in err and "TPU" not in err


@pytest.mark.parametrize("task", [SEG, SEG3D, PREDICT])
def test_hbm_check_without_a_card_exits_4(task, capsys):
    assert bench_torch.main(task + ["--hbm_check"]) == 4
    captured = capsys.readouterr()
    assert "no memory analysis" in captured.err and not captured.out


@pytest.mark.parametrize("argv,message", [
    (BYOL + ["--precrop"], "--precrop requires --store"),
    (BYOL + ["--hbm_check"], "--hbm_check supports tasks seg/seg3d/predict"),
    (SEG + ["--store", "auto"], "device-resident"),
    (PREDICT3D + ["--hbm_check"], "--hbm_check is for train steps"),
    (BYOL + ["--store", "auto", "--store_images", "3", "--store_codec", "raw"], "fewer than one batch"),
    (BYOL + ["--warmup", "0"], "--warmup must be >= 1"),
])
def test_refusals(argv, message):
    with pytest.raises(SystemExit, match=re.escape(message)):
        bench_torch.main(argv)


def test_steps_must_be_positive(capsys):
    with pytest.raises(SystemExit) as e:
        bench_torch.main(SEG + ["--steps", "0"])
    assert e.value.code == 2 and "--steps must be >= 1" in capsys.readouterr().err


def test_device_cuda_without_a_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert bench_torch.main(["--task", "seg"]) == 3
    err = capsys.readouterr().err
    assert "torch.cuda.is_available() is false" in err


def test_the_script_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"), "--task", "predict3d"],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 3 and not proc.stdout
    assert "no CUDA card" in proc.stderr


def test_peak_table_by_card_name(monkeypatch):
    cuda = torch.device("cuda")
    for name, peak in [("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 SXM5 80GB", 989.4e12),
                       ("NVIDIA H100 PCIe", 756e12), ("NVIDIA A100-SXM4-40GB", None)]:
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        assert bench_torch._peak_flops_per_chip(cuda) == peak
    assert bench_torch._peak_flops_per_chip(torch.device("cpu")) is None
    assert bench_torch._mfu(1e12, 10, 1.0, torch.device("cpu")) is None


def test_step_flops_under_autocast_count_the_convolutions():
    """FlopCounterMode over one bf16-autocast U-Net forward equals the
    convolutions' count from their shapes: autocast neither hides nor
    doubles a convolution."""
    from medical_image_segmentation_tpu_torch.models.unet import UNet

    model = UNet(arch="resnet18", n_classes=1, in_channels=1).to(memory_format=torch.channels_last).eval()
    expected = []

    def hook(mod, inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels // mod.groups
        expected.append(2 * out.numel() * k)

    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(hook)
    x = torch.randn(2, 64, 64, 1)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        flops = bench_torch._step_flops(lambda: model(x))
    assert len(expected) == 31
    assert flops == sum(expected)


def test_profile_writes_a_trace(tmp_path, capsys):
    assert bench_torch.main(SEG3D + ["--profile", str(tmp_path)]) == 0
    assert os.path.getsize(tmp_path / "trace.json") > 0
    capsys.readouterr()


def test_new_programs_import_no_jax():
    code = (
        "import importlib.util, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import bench_torch\n"
        f"spec = importlib.util.spec_from_file_location('bench_loader_torch', {os.path.join(ROOT, 'tools', 'bench_loader_torch.py')!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "import medical_image_segmentation_tpu_torch.data.store.native\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'medical_image_segmentation_tpu'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
