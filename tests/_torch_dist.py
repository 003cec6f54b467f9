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
    mesh = make_mesh(*axes, device="cpu")
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


def seg_steps(inputs_path: str, kw: dict, volumetric: bool = False, local_dice: bool = False,
              space: int = 1) -> dict:
    """Segmentation steps on this rank's rows of the global (image, mask)
    batches in ``inputs_path`` (``model``: the state dict, ``steps``), after
    the eval metrics of the initial weights on the first batch. ``local_dice`` trains on each
    rank's own Dice instead of the global one (the wrong loss, for the
    test that tells them apart). ``space`` > 1: the ranks form a
    ``("data", "space")`` mesh of (world // space, space) and each trains
    on its depth slab of its rows (eval on whole crops of its rows)."""
    from medical_image_segmentation_tpu_torch.ops.dice import dice_loss
    from medical_image_segmentation_tpu_torch.parallel.mesh import data_rows, depth_slab
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    inputs = torch.load(inputs_path, weights_only=False)
    mesh = space_mesh(space)
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
        slab = depth_slab(mesh, x.shape[1]) if volumetric else slice(None)
        out = task.train_step(torch.from_numpy(x[rows][:, slab]), torch.from_numpy(m[rows][:, slab]))
        metrics.append({k: float(v) for k, v in out.items()})
    return {"metrics": metrics, "eval": ev, "model": _numpy(task.model.state_dict())}


# --- depth sharding (tests/test_torch_space.py) -------------------------------


def space_mesh(space: int = 1):
    """``("data",)`` on the CPU for ``space`` 1, else a ``("data",
    "space")`` mesh of (world // space, space)."""
    import torch.distributed as dist

    from medical_image_segmentation_tpu_torch.parallel.mesh import make_mesh

    if space == 1:
        return make_mesh(device="cpu")
    world = dist.get_world_size()
    return make_mesh(("data", "space"), (world // space, space), device="cpu")


def halo_case(space: int, left: int, right: int, shape, seed: int) -> dict:
    """``halo_exchange`` of this rank's depth slab of a seeded global f64
    (B, C, D, H, W) tensor over its space group: the output, the input's
    gradient for a seeded cotangent of this rank, and the two sides of the
    dot-product test summed over the group."""
    from medical_image_segmentation_tpu_torch.parallel.mesh import all_reduce_, depth_slab
    from medical_image_segmentation_tpu_torch.parallel.spatial import halo_exchange

    mesh = space_mesh(space)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    slab = x[:, :, depth_slab(mesh, shape[2])].clone().requires_grad_()
    out = halo_exchange(slab, mesh.group("space"), left, right)
    y = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed + 1 + mesh.rank), dtype=torch.float64)
    (out * y).sum().backward()
    dots = torch.stack([(out * y).sum(), (slab * slab.grad).sum()]).detach()
    all_reduce_(dots, mesh.group("space"))
    return {"out": out.detach().numpy(), "grad": slab.grad.numpy(), "cotangent": y.numpy(),
            "dots": dots.tolist(), "contiguous_channels_last": out.is_contiguous(memory_format=torch.channels_last_3d)}


def space_layers_case(space: int, seed: int) -> dict:
    """This rank's depth slab through the sharded 3³ convolutions (stride 1
    and 2) and GroupNorm of ``models/unet3d.py``, forward and backward for a
    seeded cotangent: the outputs and the gradients of the slab and of the
    parameters (the parameters' summed over the ranks make the whole
    volume's)."""
    from medical_image_segmentation_tpu_torch.models import unet3d
    from medical_image_segmentation_tpu_torch.parallel.mesh import depth_slab

    mesh = space_mesh(space)
    group = mesh.group("space")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 6, 8 * space, 6, 5), generator=gen)
    conv1, conv2 = unet3d._conv3(6, 4), unet3d._conv3(6, 6, stride=2)
    norm = unet3d.GroupNorm(3, 6)
    for m in (conv1, conv2, norm):
        for p in m.parameters():
            p.data.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    out = {}
    for name, fn in (("conv1", lambda t: unet3d._sharded_conv(conv1, t, group)),
                     ("conv2", lambda t: unet3d._sharded_conv(conv2, t, group)),
                     ("norm", lambda t: unet3d.group_norm(t, 3, norm.weight, norm.bias, norm.eps, group))):
        for m in (conv1, conv2, norm):
            m.zero_grad(set_to_none=True)
        slab = x[:, :, depth_slab(mesh, x.shape[2])].clone().contiguous(
            memory_format=torch.channels_last_3d).requires_grad_()
        y = fn(slab)
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed + 7 + mesh.rank))
        (y * cot).sum().backward()
        params = {f"{m_name}.{k}": p.grad.numpy().copy() for m_name, m in (("conv1", conv1), ("conv2", conv2),
                                                                           ("norm", norm))
                  for k, p in m.named_parameters() if p.grad is not None}
        out[name] = {"y": y.detach().numpy(), "grad": slab.grad.numpy(), "cotangent": cot.numpy(), "params": params}
    return out


def unet3d_space_case(space: int, shape, features, seed: int, norm: str = "group") -> dict:
    """A ``UNet3D`` of ``features`` from ``seed`` on this rank's depth slab
    of a seeded global NDHWC batch, in train mode: the logits' slab, and
    the gradients of the slab and of the parameters for a seeded cotangent
    (the rank's part of the whole-volume sum)."""
    from medical_image_segmentation_tpu_torch.models.batchnorm import set_group
    from medical_image_segmentation_tpu_torch.models.unet3d import UNet3D, set_space_group
    from medical_image_segmentation_tpu_torch.parallel.mesh import depth_slab

    mesh = space_mesh(space)
    model = UNet3D(features=tuple(features), norm=norm).to(memory_format=torch.channels_last_3d)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    set_space_group(model, mesh.group("space"))
    set_group((model,), mesh.group("all"))
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1))
    cot = torch.randn((*shape[:-1], 1), generator=torch.Generator().manual_seed(seed + 2))
    slab = depth_slab(mesh, shape[1])
    xs = x[:, slab].clone().requires_grad_()
    y = model(xs)
    (y * cot[:, slab]).sum().backward()
    return {"y": y.detach().numpy(), "grad": xs.grad.numpy(),
            "params": {k: p.grad.numpy().copy() for k, p in model.named_parameters()}}


def trainer_refusal(argv) -> str:
    """The message of the SystemExit that ``mis-train-segmentation3d-torch``
    raises on ``argv`` in these ranks, or "" if it ran."""
    from medical_image_segmentation_tpu_torch.train import train_segmentation3d

    try:
        train_segmentation3d.run(argv)
    except SystemExit as e:
        return str(e)
    return ""
