"""Run a function in N gloo ranks on the CPU, for the PyTorch port's
multi-process tests. Imports torch and the port only (no JAX), so the
spawned ranks start fast.

``launch(fn, n, *args)`` (or ``Launch``, which lets the caller work
while the ranks run) spawns ``n`` processes with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), joins them into one group through the
port's ``initialize_distributed("cpu")``, calls ``fn(*args)`` in each and
returns the list of what each rank returned (picklable values). A rank
that raises fails the launch with its traceback.
"""

from __future__ import annotations

import os
import socket
import tempfile
import traceback

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _entry(fn, rank: int, world: int, port: int, args, out_dir: str) -> None:
    os.environ.update(rank_env(rank, world, port))
    torch.set_num_threads(1)
    from medical_image_segmentation_tpu_torch.parallel.mesh import initialize_distributed, shutdown_distributed

    try:
        initialize_distributed("cpu")
        result = ("ok", fn(*args))
    except BaseException:  # reported to the parent, which fails the test
        result = ("error", traceback.format_exc())
    finally:
        shutdown_distributed()
    torch.save(result, os.path.join(out_dir, f"{rank}.pt"))


class Launch:
    """``world`` spawned ranks running ``fn(*args)``; ``results()`` waits
    for them. The caller may work meanwhile."""

    def __init__(self, fn, world: int, *args, timeout: float = 240.0):
        self.world, self.timeout = world, timeout
        self._dir = tempfile.TemporaryDirectory()
        ctx = mp.get_context("spawn")
        port = free_port()
        self._procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args, self._dir.name))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def results(self) -> list:
        try:
            for p in self._procs:
                p.join(self.timeout)
            alive = [p for p in self._procs if p.is_alive()]
            for p in alive:
                p.kill()
            if alive:
                raise RuntimeError(f"{len(alive)} of {self.world} ranks did not finish in {self.timeout} s")
            results = []
            for r, p in enumerate(self._procs):
                path = os.path.join(self._dir.name, f"{r}.pt")
                if not os.path.exists(path):
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode} and no result")
                status, value = torch.load(path, weights_only=False)
                if status != "ok":
                    raise RuntimeError(f"rank {r} failed:\n{value}")
                results.append(value)
            return results
        finally:
            self._dir.cleanup()


def launch(fn, world: int, *args, timeout: float = 240.0) -> list:
    return Launch(fn, world, *args, timeout=timeout).results()


def run_all(calls) -> list:
    """``[fn(*args) for fn, args in calls]``: several cases in one launch."""
    return [fn(*args) for fn, args in calls]


# --- step workers: the same code runs in every rank and, without a group, in
# the test process as the one-rank reference ----------------------------------


def _numpy(state):
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def byol_steps(inputs_path: str, kw: dict, axes=(("data",), None), ckpt_dir: str = "") -> dict:
    """BYOL steps on this rank's rows of the global views in
    ``inputs_path`` (``online``/``target`` state dicts, ``steps``: a list
    of (v1, v2, labels-or-None) global numpy batches). Returns the metrics
    of every step and the whole online and target state dicts after.
    ``ckpt_dir``: also write the trainer's checkpoint there (rank 0), load
    it back into a fresh task of the same mesh, and return the eval-mode
    forward (p, z) of both tasks on the first step's ``v1``."""
    from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint, save_rank0
    from medical_image_segmentation_tpu_torch.parallel.mesh import data_rows, make_mesh
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask

    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh(*axes)
    task = BYOLTask(dtype=torch.float32, device="cpu", mesh=mesh, **kw)
    task.load_state_dict({"step": 0, "online": inputs["online"], "target": inputs["target"]})
    metrics = []
    for v1, v2, labels in inputs["steps"]:
        rows = data_rows(mesh, v1.shape[0])
        m = task.train_step(torch.from_numpy(v1[rows]), torch.from_numpy(v2[rows]),
                            None if labels is None else torch.from_numpy(labels[rows]))
        metrics.append({k: float(v) for k, v in m.items()})
    state = task.state_dict()
    out = {"metrics": metrics, "online": _numpy(state["online"]), "target": _numpy(state["target"]),
           "momentum": {i: st["momentum_buffer"].numpy().copy() for i, st in state["optimizer"]["state"].items()}}
    if ckpt_dir:
        save_rank0(ckpt_dir, state, task.step, mesh)
        again = BYOLTask(dtype=torch.float32, device="cpu", mesh=mesh, **kw)
        again.load_state_dict(load_checkpoint(ckpt_dir))
        x = torch.from_numpy(inputs["steps"][0][0])
        out["forward"] = [byol_forward(t, x) for t in (task, again)]
        out["reloaded"] = _numpy(again.state_dict()["online"])
    return out


@torch.no_grad()
def byol_forward(task, x: torch.Tensor):
    """Eval-mode predictions and projections of ``task``'s online net."""
    task.online.eval()
    try:
        p, z, _, _ = task.online(x)
    finally:
        task.online.train()
    return p.numpy().copy(), z.numpy().copy()


def seg_steps(inputs_path: str, kw: dict, volumetric: bool = False, local_dice: bool = False) -> dict:
    """Segmentation steps on this rank's rows of the global (image, mask)
    batches in ``inputs_path`` (``model``: the state dict, ``steps``), after
    the eval metrics of the initial weights on the first batch. ``local_dice`` trains on each
    rank's own Dice instead of the global one (the wrong loss, for the
    test that tells them apart)."""
    from medical_image_segmentation_tpu_torch.ops.dice import dice_loss
    from medical_image_segmentation_tpu_torch.parallel.mesh import data_rows, make_mesh
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh()
    task = (Segmentation3DTask if volumetric else SegmentationTask)(dtype=torch.float32, device="cpu", mesh=mesh,
                                                                    **kw)
    task.model.load_state_dict(inputs["model"])
    if local_dice:
        task._loss = lambda logits, masks, group=None: dice_loss(logits, masks)
    x, m = inputs["steps"][0]
    rows = data_rows(mesh, x.shape[0])
    ev = {k: float(v) for k, v in task.eval_step(torch.from_numpy(x[rows]), torch.from_numpy(m[rows])).items()}
    metrics = []
    for x, m in inputs["steps"]:
        rows = data_rows(mesh, x.shape[0])
        out = task.train_step(torch.from_numpy(x[rows]), torch.from_numpy(m[rows]))
        metrics.append({k: float(v) for k, v in out.items()})
    return {"metrics": metrics, "eval": ev, "model": _numpy(task.model.state_dict())}
