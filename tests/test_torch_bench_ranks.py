"""``bench_torch.py`` over every card of a launch, on the CPU.

Two gloo ranks (``tests/_torch_dist.py::launch``, torchrun's variables)
run ``bench_torch.main`` at the toy argv of ``tests/test_torch_bench.py``:
byol, seg, seg3d and byol on a raw ``--store auto``, then the refusals and
``--hbm_check`` against a stated capacity (rank r's probe peaks at r + 1
GiB: the line reports the larger, and both ranks exit 2 where rank 1 does
not fit). In every run only rank 0 prints the JSON line, with ``ranks`` 2
and ``backend`` gloo, and ``value`` is ``total_per_sec`` over the ranks.
Each rank calls the augmentation kernel's plain version (the CPU's route
of ``fused_two_view_augment``) once a step of byol it takes.

The ranks' parameters after the run, the gradients of the first step
(taken at the initial weights, after the ranks averaged theirs) and every
step's loss are held to the one-process run on the same global batch (this
process runs it while the ranks run); parameters and gradients per group
by max|a-b| over max|b| as in ``tests/test_torch_ddp.py``. The bound is
1e-5, or three times the one-process run's own spread where that is
larger: the largest error of the one-process run under a 1e-6 change of
the step's input and under a 2^-8 one. The bench's steps take bf16 input
under autocast, where a 1e-6 change mostly rounds away (the seg run does
not move at all), so the 2^-8 change, one bf16 step, gives the rounding
noise the ranks' sums add. The change is made to the step's f32 input
where there is one (the 3D volumes) and to the views' normalisation
statistics otherwise. The seg and seg3d benches train at a learning rate
of 0 (their schedule warms up by epoch), so their parameters do not move
and their gradients and losses carry the check. The ranks end equal to
the bit.

``value`` and ``mfu`` are held to ``bench.py``'s own expressions, run from
its source. predict runs over two replicas with ``local_devices`` patched to
two CPU devices: ``devices`` 2 and the masks of one device.
"""

import ast
import contextlib
import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import _torch_dist as td
from test_torch_bench import BYOL, PREDICT, PREDICT3D, SEG, SEG3D, STORE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

torch.set_num_threads(2)

RANKS = 2
TRAIN = {"byol": BYOL, "seg": SEG, "seg3d": SEG3D}
RUNS = {**TRAIN, "byol_store_raw": BYOL + STORE + ["--store_codec", "raw"]}
REFUSALS = {
    "odd_batch": (SEG[:-4] + ["--batch_size", "3", "--image_size", "64"], "--batch_size 3 must divide 2 devices"),
    "predict": (PREDICT, "--task predict runs in one process (2 ranks asked for)"),
    "predict3d": (PREDICT3D, "--task predict3d runs in one process (2 ranks asked for)"),
}
HBM_CAPACITIES = (1.5, 3.0)  # GiB: rank 1's 2 GiB step does not fit the first, both fit the second
STEPS_RUN = 1 + 2 + 2 + 1  # warmup, timed, probe, the FLOP count's
SPREADS = (1 + 1e-6, 1 + 2 ** -8)  # 1e-6, and one bf16 step: the bench steps take bf16 input


@contextlib.contextmanager
def recording(scale: float = 1.0):
    """Records the task a bench run makes and the calls of the kernel's
    plain version; ``scale`` != 1 changes the step's input by that factor
    (the 3D volumes; the views' normalisation statistics of byol and seg)."""
    from medical_image_segmentation_tpu_torch.ops import augment, augment3d
    from medical_image_segmentation_tpu_torch.ops import fused_augment as fa
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    rec = {"tasks": [], "plain_calls": 0, "losses": [], "grads": None}
    saved = [(cls, "init", cls.init) for cls in (BYOLTask, SegmentationTask)]
    saved += [(cls, "train_step", cls.train_step) for cls in (BYOLTask, SegmentationTask)]
    saved += [(fa, "two_view_augment_reference", fa.two_view_augment_reference),
              (fa, "fused_two_view_augment", fa.fused_two_view_augment),
              (augment, "segmentation_augment", augment.segmentation_augment),
              (augment3d, "segmentation_augment_3d", augment3d.segmentation_augment_3d)]

    def init(orig):
        def fn(self, seed):
            rec["tasks"].append(self)
            return orig(self, seed)
        return fn

    def step(orig):
        def fn(self, *args):
            m = orig(self, *args)
            rec["losses"].append(float(m["loss" if "loss" in m else "train/loss"]))
            if rec["grads"] is None:  # the first step's (averaged) gradients, taken at the initial weights
                net = self.online if hasattr(self, "online") else self.model
                rec["grads"] = {k: p.grad.detach().cpu().numpy().copy() for k, p in net.named_parameters()
                                if p.grad is not None}
            return m
        return fn

    def plain(*args, **kw):
        rec["plain_calls"] += 1
        return saved[4][2](*args, **kw)

    def fused(images, cfg1, cfg2, *args, **kw):  # std is the default (57.9764,)
        return saved[5][2](images, cfg1, cfg2, std=(60.4759 / scale,), **kw)

    def seg2d(gen, images, masks, size, mean, std, **kw):
        return saved[6][2](gen, images, masks, size, mean, tuple(s / scale for s in std), **kw)

    def seg3d(gen, vols, masks, **kw):
        return saved[7][2](gen, vols * scale, masks, **kw)

    BYOLTask.init, SegmentationTask.init = init(saved[0][2]), init(saved[1][2])
    BYOLTask.train_step, SegmentationTask.train_step = step(saved[2][2]), step(saved[3][2])
    fa.two_view_augment_reference = plain
    if scale != 1.0:
        fa.fused_two_view_augment, augment.segmentation_augment = fused, seg2d
        augment3d.segmentation_augment_3d = seg3d
    try:
        yield rec
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def state_of(task) -> dict:
    sd = task.state_dict()
    sides = ("online", "target") if "online" in sd else ("model",)
    return {side: {k: v.detach().cpu().numpy().copy() for k, v in sd[side].items()} for side in sides}


def bench_run(argv, scale: float = 1.0) -> dict:
    """One ``bench_torch.main(argv)``: its exit code or refusal, stdout and
    stderr lines, the plain kernel's calls and the state it trained."""
    out, err = io.StringIO(), io.StringIO()
    with recording(scale) as rec, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc, refusal = bench_torch.main(argv), ""
        except SystemExit as e:
            rc, refusal = None, str(e)
    return {"rc": rc, "refusal": refusal, "stdout": out.getvalue().splitlines(),
            "stderr": err.getvalue().splitlines(), "plain_calls": rec["plain_calls"],
            "losses": rec["losses"], "grads": rec["grads"],
            "state": state_of(rec["tasks"][-1]) if rec["tasks"] and rc == 0 else None}


def hbm_check_run(capacity_gib: float) -> dict:
    """``--task seg --hbm_check`` in this rank against a card of
    ``capacity_gib``, where rank r's probe step peaks at r + 1 GiB (the
    step runs; the CPU has no memory to read)."""
    import torch.distributed as dist

    from medical_image_segmentation_tpu_torch.core import hbm

    saved = hbm.device_hbm_capacity, hbm.probe_peak

    def probe_peak(probe, device):
        probe()
        return (dist.get_rank() + 1) * 2 ** 30

    hbm.device_hbm_capacity, hbm.probe_peak = (lambda device: int(capacity_gib * 2 ** 30)), probe_peak
    try:
        return bench_run(SEG + ["--hbm_check"])
    finally:
        hbm.device_hbm_capacity, hbm.probe_peak = saved


def _rank_runs() -> dict:
    torch.set_num_threads(1)
    out = {name: bench_run(argv) for name, argv in RUNS.items()}
    out.update({f"refuse_{name}": bench_run(argv) for name, (argv, _) in REFUSALS.items()})
    out.update({f"hbm_{gib}": hbm_check_run(gib) for gib in HBM_CAPACITIES})
    import torch.distributed as dist

    for name, run in out.items():  # rank 0's states travel back where they are compared, the others' digests
        if name not in TRAIN:
            run["state"] = run["grads"] = None
        elif dist.get_rank():
            run["state"], run["grads"] = digest(run["state"]), digest(run["grads"])
    return out


def digest(tree) -> str:
    """A SHA-256 of every array in ``tree`` (dicts in key order)."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                h.update(str(k).encode())
                walk(t[k])
        else:
            h.update(np.ascontiguousarray(t).tobytes())

    walk(tree)
    return h.hexdigest()


@pytest.fixture(scope="module")
def runs():
    """The two ranks' runs, and meanwhile the one-process runs of the train
    tasks and their runs under each change of the input, in this process."""
    launch = td.Launch(_rank_runs, RANKS, timeout=300.0)
    one = {name: bench_run(argv) for name, argv in TRAIN.items()}
    spread = {(name, scale): bench_run(argv, scale) for name, argv in TRAIN.items() for scale in SPREADS}
    return {"ranks": launch.results(), "one": one, "spread": spread}


def line_of(run) -> dict:
    assert run["rc"] == 0, run["stderr"][-20:]
    return json.loads(run["stdout"][-1])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_rank0_prints_the_one_line(runs, name):
    r0, r1 = (r[name] for r in runs["ranks"])
    line = line_of(r0)
    assert r1["rc"] == 0 and r1["stdout"] == []
    (other,) = [json.loads(ln.split("] ", 1)[1]) for ln in r1["stderr"] if ln.startswith("[rank 1] ")]
    own = [k for k in line if k.endswith(("_ms_per_batch", "_batches_timed"))]  # each rank's loader timers
    assert {k: v for k, v in other.items() if k not in own} == {k: v for k, v in line.items() if k not in own}
    assert line["ranks"] == RANKS and line["backend"] == "gloo" and line["gpus"] == 0
    digits = 2 if name == "seg3d" else 1
    assert line["value"] == round(line["total_per_sec"] / RANKS, digits) and line["value"] > 0
    assert line["steps_run"] == STEPS_RUN and line["mfu"] is None


@pytest.mark.parametrize("name", sorted(RUNS))
def test_kernel_runs_once_a_step_in_each_rank(runs, name):
    calls = [r[name]["plain_calls"] for r in runs["ranks"]]
    assert calls == ([STEPS_RUN] * RANKS if name.startswith("byol") else [0] * RANKS)


def test_store_mode_shards_the_store(runs):
    line = line_of(runs["ranks"][0]["byol_store_raw"])
    assert line["mode"] == "store" and line["reader"] in ("native", "python")
    assert line["h2d_bytes_per_batch"] == 4 * 64 * 64  # the global batch's frames
    assert line["num_decode_threads"] == max(1, os.cpu_count() // RANKS)


def _group_err(a, b, keys) -> float:
    return (max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in keys)
            / max(float(np.abs(b[k]).max()) for k in keys))


def _groups(sd):
    stats = [k for k in sd if "running_" in k]
    return {"params": [k for k in sd if k not in stats and "num_batches" not in k], "stats": stats}


def _tolerance(runs, name, err) -> float:
    """1e-5, or three times the largest error ``err(run)`` of the
    one-process run under a change of its input."""
    return max(1e-5, 3 * max(err(runs["spread"][(name, scale)]) for scale in SPREADS))


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_parameters_equal_the_one_process_run(runs, name):
    one = runs["one"][name]["state"]
    got = runs["ranks"][0][name]["state"]
    for side, want in one.items():
        for group, keys in _groups(want).items():
            if not keys:
                continue
            tol = _tolerance(runs, name, lambda run: _group_err(run["state"][side], want, keys))
            err = _group_err(got[side], want, keys)
            assert err <= tol, (side, group, err, tol)
    # the ranks end equal to the bit
    assert runs["ranks"][1][name]["state"] == digest(got)


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_first_step_gradients_equal_the_one_process_step(runs, name):
    """The gradients of the first step, taken at the same initial weights,
    after the ranks averaged theirs."""
    want = runs["one"][name]["grads"]
    keys = sorted(want)
    tol = _tolerance(runs, name, lambda run: _group_err(run["grads"], want, keys))
    got = runs["ranks"][0][name]["grads"]
    assert sorted(got) == keys and _group_err(got, want, keys) <= tol
    assert runs["ranks"][1][name]["grads"] == digest(got)  # every rank steps with the same mean


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_every_step_s_loss_is_the_global_batch_s(runs, name):
    want = np.array(runs["one"][name]["losses"])
    assert len(want) == STEPS_RUN
    tol = _tolerance(runs, name, lambda run: float(np.max(np.abs(np.array(run["losses"]) - want) / np.abs(want))))
    for r in runs["ranks"]:
        got = np.array(r[name]["losses"])
        assert float(np.max(np.abs(got - want) / np.abs(want))) <= tol, (got, want, tol)


def test_one_process_line_says_one_rank(runs):
    line = line_of(runs["one"]["seg"])
    assert line["ranks"] == 1 and line["backend"] is None and line["gpus"] == 0
    assert line["value"] == round(line["total_per_sec"], 1)


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_under_two_ranks(runs, name):
    for r in runs["ranks"]:
        run = r[f"refuse_{name}"]
        assert run["rc"] is None and run["stdout"] == []
        assert REFUSALS[name][1] in run["refusal"]


@pytest.mark.parametrize("gib", HBM_CAPACITIES)
def test_hbm_check_reports_the_largest_rank_and_the_worst_exit(runs, gib):
    r0, r1 = (r[f"hbm_{gib}"] for r in runs["ranks"])
    fits = gib > 2
    assert r0["rc"] == r1["rc"] == (0 if fits else 2)
    assert r1["stdout"] == [] and len(r0["stdout"]) == 1
    line = json.loads(r0["stdout"][0])
    assert line["metric"] == "seg_projected_hbm_gb" and line["value"] == 2.0
    assert line["hbm_oversubscribed"] is (not fits) and line["hbm_capacity_gb"] == gib
    assert line["ranks"] == RANKS and line["backend"] == "gloo"


def _bench_py_expr(func: str, target: str):
    """The expression ``bench.py``'s ``func`` assigns to ``target`` (its
    last such assignment), compiled."""
    tree = ast.parse(open(BENCH_PY).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    nodes = [n for n in ast.walk(fn) if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == target]
    value = nodes[-1].value
    if isinstance(value, ast.IfExp):  # "... if flops and peak else None"
        value = value.body
    return compile(ast.Expression(value), BENCH_PY, "eval")


@pytest.mark.parametrize("func,rate", [("main", "imgs_per_sec"), ("_seg_bench", "imgs_per_sec"),
                                       ("_seg3d_bench", "vols_per_sec")])
@pytest.mark.parametrize("chips", [1, 2, 4, 8])
def test_per_chip_and_mfu_are_bench_py_s(monkeypatch, func, rate, chips):
    rng = np.random.default_rng(chips)
    peak = 989.4e12
    monkeypatch.setattr(bench_torch, "_peak_flops_per_chip", lambda d: peak)
    for _ in range(20):
        total, flops, steps, dt = rng.uniform(1, 5e4), rng.uniform(1e9, 1e13), int(rng.integers(1, 50)), \
            rng.uniform(0.01, 30)
        ns = {rate: total, "n_chips": chips, "flops": flops, "peak": peak, "dt": dt,
              "args": type("A", (), {"steps": steps})}
        digits = 2 if func == "_seg3d_bench" else 1
        assert bench_torch._rate_fields(total, chips, digits)["value"] == round(
            eval(_bench_py_expr(func, "per_chip"), ns), digits)
        assert bench_torch._mfu(flops, steps, dt, torch.device("cuda"), chips) == eval(
            _bench_py_expr(func, "mfu"), ns)


def _predict_run(monkeypatch, devices):
    """``--task predict`` over ``devices`` (``local_devices`` patched) and
    the masks of its last call."""
    from medical_image_segmentation_tpu_torch import serve
    from medical_image_segmentation_tpu_torch.parallel import replicas

    masks = []
    make = serve.make_predict_fn

    def recorded(*args, **kw):
        fn = make(*args, **kw)
        return lambda x: masks.append(fn(x)) or masks[-1]

    monkeypatch.setattr(serve, "make_predict_fn", recorded)
    monkeypatch.setattr(replicas, "local_devices", lambda name: [torch.device(d) for d in devices])
    run = bench_run(PREDICT + ["--exported"])
    return line_of(run), masks[-1]


def test_predict_over_two_replicas(monkeypatch):
    line, masks = _predict_run(monkeypatch, ["cpu", "cpu"])
    one_line, one_masks = _predict_run(monkeypatch, ["cpu"])
    assert line["devices"] == 2 and one_line["devices"] == 1
    assert line["gpus"] == one_line["gpus"] == 0 and line["ranks"] == 1
    assert line["value"] == round(line["total_per_sec"] / 2, 1)
    assert line["exported_batch"] == 1 and one_line["exported_batch"] == 2  # one device's share, as bench.py
    assert masks.shape == (2, 64, 64, 1) and torch.equal(masks, one_masks)


def test_predict_refuses_a_batch_the_replicas_do_not_divide(monkeypatch):
    from medical_image_segmentation_tpu_torch.parallel import replicas

    monkeypatch.setattr(replicas, "local_devices", lambda name: [torch.device("cpu")] * 3)
    with pytest.raises(SystemExit, match="--batch_size 2 must divide 3 devices"):
        bench_torch.main(PREDICT)
