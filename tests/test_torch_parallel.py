"""The PyTorch port's multi-process layer (``parallel/mesh.py``,
``parallel/tp.py``) and what rides on it, in gloo ranks on the CPU.

- the launch environment → layout: torchrun's, SLURM's, none;
- the backend rule ("ranks share a card → gloo") and that a group that
  cannot form raises instead of trying another backend;
- a (data=2, model=2) mesh over 4 ranks: coordinates, axis groups, and
  collectives over each group;
- the differentiable all-reduce, Megatron's two conjugate operators, the
  row gather with unequal row counts, the global BatchNorm's forward,
  backward and running statistics against one process on the whole
  batch, LARS's whole-tensor norms of sharded parameters, the lockstep
  stop, the KNN bank gathered over ranks, and a rank-0 checkpoint;
- rank-sliced augmentation draws: a rank's draws are its rows of the
  global batch's draws.

Every multi-rank check runs in one launch of 4 ranks (one test process
spawns them once); each test reads its part of the result.
"""

import datetime
import os
import subprocess
import sys

import pytest
import torch

import _torch_dist as td
from medical_image_segmentation_tpu_torch.ops import augment as taug
from medical_image_segmentation_tpu_torch.ops import augment3d as taug3d
from medical_image_segmentation_tpu_torch.ops import fused_augment as fa
from medical_image_segmentation_tpu_torch.parallel import mesh as pm
from medical_image_segmentation_tpu_torch.parallel import tp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


# ------------------------------------------------------------ layout and rule


def test_no_launch_environment_is_one_process():
    assert pm.layout_from_env({}) is None
    assert pm.layout_from_env({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}) is None
    proc = pm.initialize_distributed("cpu", env={})
    assert (proc.rank, proc.world_size, proc.backend, proc.is_main) == (0, 1, None, True)
    mesh = pm.make_mesh(device="cpu")
    assert mesh.world_size == 1 and mesh.group("data") is None and mesh.ranks("data") == [0]


def test_torchrun_environment():
    env = {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4",
           "MASTER_ADDR": "node0", "MASTER_PORT": "29500"}
    assert pm.layout_from_env(env) == pm.Layout(5, 8, 1, 4, "node0", 29500, "torchrun")
    one = pm.layout_from_env({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "h", "MASTER_PORT": "1"})
    assert one is not None and one.world_size == 1  # a named group of one still forms a group
    with pytest.raises(SystemExit, match="MASTER_ADDR and MASTER_PORT"):
        pm.layout_from_env({"RANK": "0", "WORLD_SIZE": "2"})
    with pytest.raises(SystemExit, match="out of range"):
        pm.layout_from_env({"RANK": "2", "WORLD_SIZE": "2", "MASTER_ADDR": "h", "MASTER_PORT": "1"})


@pytest.mark.parametrize("env,local_world", [
    ({"SLURM_NTASKS_PER_NODE": "4"}, 4),
    ({"SLURM_TASKS_PER_NODE": "2(x3),1"}, 2),
    ({}, 6),
])
def test_slurm_environment(env, local_world):
    base = {"SLURM_NTASKS": "6", "SLURM_PROCID": "3", "SLURM_LOCALID": "1", "MASTER_ADDR": "n0",
            "MASTER_PORT": "12345"}
    assert pm.layout_from_env({**base, **env}) == pm.Layout(3, 6, 1, local_world, "n0", 12345, "slurm")


@pytest.mark.parametrize("device,local_world,cards,backend", [
    ("cpu", 4, 0, "gloo"),
    ("cuda", 1, 1, "nccl"),
    ("cuda", 8, 8, "nccl"),
    ("cuda", 2, 1, "gloo"),   # two ranks share the one card: NCCL refuses that
    ("cuda", 8, 4, "gloo"),
])
def test_backend_rule(device, local_world, cards, backend):
    assert pm.choose_backend(torch.device(device), local_world, cards) == backend


def test_a_card_is_the_default_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        pm.initialize_distributed("cuda", env={})
    assert pm.rank_device("cpu", None) == torch.device("cpu")


def test_a_group_that_cannot_form_raises():
    """Rank 1 of 2 whose rank 0 never comes: the init raises after its
    timeout, in a process of its own, and no group is left formed."""
    code = (
        "import datetime, sys, torch.distributed as dist\n"
        "from medical_image_segmentation_tpu_torch.parallel.mesh import initialize_distributed\n"
        "env = {'RANK': '1', 'WORLD_SIZE': '2', 'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': sys.argv[1]}\n"
        "try:\n"
        "    initialize_distributed('cpu', env=env, timeout=datetime.timedelta(seconds=3))\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, dist.is_initialized())\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(td.free_port())], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised") and out.stdout.split()[-1] == "False", out.stdout


# ------------------------------------------------------------ draws per rank


def test_rank_draws_are_rows_of_the_global_draws():
    images = torch.randint(0, 256, (4, 40, 40, 1), dtype=torch.uint8)
    vols = torch.rand(4, 10, 12, 12, 1)
    cfg1, cfg2 = (taug.ViewConfig(out_size=(16, 16)), taug.ViewConfig(out_size=(16, 16), solarize_prob=0.5))

    def gen():
        return torch.Generator().manual_seed(3)

    whole = fa.sample_view_params(gen(), 8, 40, 40, cfg1, cfg2)
    for r in range(2):
        rows = slice(4 * r, 4 * r + 4)
        assert torch.equal(taug.keep_rows(fa.sample_view_params(gen(), 8, 40, 40, cfg1, cfg2), (r, 2)), whole[rows])
        v = fa.fused_two_view_augment(images, cfg1, cfg2, dtype=torch.float32, generator=gen(), shard=(r, 2))
        want = fa.fused_two_view_augment(images, cfg1, cfg2, dtype=torch.float32, params=whole[rows])
        assert all(torch.equal(a, b) for a, b in zip(v, want))
    # plain views, segmentation and volumes: two ranks of 2 rows = one rank of 4
    cases = [
        lambda g, rows, sh: taug.two_view_augment(g, images[rows], cfg1, cfg2, dtype=torch.float32, shard=sh),
        lambda g, rows, sh: taug.segmentation_augment(g, images[rows], images[rows].float() / 255,
                                                      out_size=(16, 16), shard=sh),
        lambda g, rows, sh: taug3d.byol_two_view_augment_3d(g, vols[rows], out_size=(8, 8, 8), shard=sh),
        lambda g, rows, sh: taug3d.segmentation_augment_3d(g, vols[rows], vols[rows], out_size=(8, 8, 8), shard=sh),
    ]
    for fn in cases:
        one = fn(gen(), slice(0, 4), (0, 1))
        halves = [fn(gen(), slice(2 * r, 2 * r + 2), (r, 2)) for r in range(2)]
        for k in range(2):
            assert torch.equal(torch.cat([h[k] for h in halves]), one[k])


# ------------------------------------------------------------ four ranks


def _bn_case(group, rank, data_rank, data_size):
    """A global BatchNorm on this rank's rows against one process's
    BatchNorm on all rows: outputs, input gradients, the scale's and bias's
    gradients summed over ranks, running statistics."""
    from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm, set_group

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 3, 4, 4, generator=g) * 2 + 1
    dy = torch.randn(8, 3, 4, 4, generator=g)
    ref = BatchNorm(3)
    with torch.no_grad():
        ref.weight.uniform_(0.5, 1.5, generator=g)
        ref.bias.uniform_(-1, 1, generator=g)
    bn = BatchNorm(3)
    bn.load_state_dict(ref.state_dict())
    set_group([bn], group)
    xa = x.clone().requires_grad_(True)
    ref(xa).backward(dy)
    rows = slice(data_rank * 8 // data_size, (data_rank + 1) * 8 // data_size)
    xl = x[rows].clone().requires_grad_(True)
    y = bn(xl)
    y.backward(dy[rows])
    wgrad = pm.all_reduce_(bn.weight.grad.clone(), group)
    bgrad = pm.all_reduce_(bn.bias.grad.clone(), group)
    with torch.no_grad():
        y_ref = ref(x)  # second call, training: the ref's running stats move again, ours not
    return {"y": float((y - y_ref[rows]).abs().max()),
            "dx": float((xl.grad - xa.grad[rows]).abs().max()),
            "dw": float((wgrad - ref.weight.grad).abs().max()), "db": float((bgrad - ref.bias.grad).abs().max()),
            "mean": float((bn.running_mean - (0.9 * 0 + 0.1 * x.mean((0, 2, 3)))).abs().max()),
            "var": float((bn.running_var - (0.9 + 0.1 * x.var((0, 2, 3), unbiased=False))).abs().max())}


def _four_ranks(ckpt_dir):
    import torch.distributed as dist

    from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint, save_rank0
    from medical_image_segmentation_tpu_torch.eval.knn import KNNEvaluator
    from medical_image_segmentation_tpu_torch.ops.lars import LARS
    from medical_image_segmentation_tpu_torch.train.resilience import PreemptionGuard

    rank = dist.get_rank()
    mesh = pm.make_mesh(("data", "model"), (2, 2))
    data, model = mesh.group("data"), mesh.group("model")
    out = {"coords": mesh.coords, "data_ranks": mesh.ranks("data"), "model_ranks": mesh.ranks("model"),
           "data_sum": int(pm.all_reduce_(torch.tensor([rank]), data)),
           "model_sum": int(pm.all_reduce_(torch.tensor([rank]), model)),
           "world_sum": int(pm.all_reduce_(torch.tensor([rank]), dist.group.WORLD))}

    # differentiable all-reduce: y = Σ_r c_r·x_r on every rank, loss_r = w_r·y
    x = torch.tensor([float(rank + 1)], requires_grad=True)
    y = pm.all_reduce_sum(x * (rank + 2), dist.group.WORLD)
    (y * (10.0 + rank)).sum().backward()
    out["allreduce"] = (float(y), float(x.grad))

    # Megatron's f and g over the model group
    a = torch.tensor([2.0], requires_grad=True)
    f = tp.copy_to_group(a, model)
    (f * (mesh.index("model") + 1.0)).sum().backward()
    b = torch.tensor([float(mesh.index("model") + 1)], requires_grad=True)
    gsum = tp.reduce_from_group(b, model)
    (gsum * 3.0).sum().backward()
    out["f"] = (float(f), float(a.grad))
    out["g"] = (float(gsum), float(b.grad))

    # row gather with unequal rows; a whole tensor from model slices
    rows = torch.arange(rank + 1, dtype=torch.float32)[:, None] + 10 * rank
    out["gathered"] = pm.gather_rows(rows, dist.group.WORLD).squeeze(1).tolist()
    whole = torch.arange(12.0).view(3, 4)
    part = tp.shard_tensor(whole, 1, mesh.index("model"), 2)
    out["tp_gather"] = bool(torch.equal(tp.gather_tensor(part, 1, model), whole))

    out["bn"] = _bn_case(data, rank, mesh.index("data"), 2)

    # LARS: the trust ratio of a model-sharded weight uses the whole norm
    w_whole = torch.arange(1.0, 9.0).view(2, 4) / 10
    g_whole = torch.arange(8.0, 0.0, -1.0).view(2, 4) / 100
    w = torch.nn.Parameter(tp.shard_tensor(w_whole, 0, mesh.index("model"), 2).clone())
    w.grad = tp.shard_tensor(g_whole, 0, mesh.index("model"), 2).clone()
    LARS([w], lr=1.0, weight_decay=0.1, momentum=0.0, sharded=[w], norm_group=model).step()
    ref = torch.nn.Parameter(w_whole.clone())
    ref.grad = g_whole.clone()
    LARS([ref], lr=1.0, weight_decay=0.1, momentum=0.0).step()
    out["lars"] = float((w.detach() - tp.shard_tensor(ref.detach(), 0, mesh.index("model"), 2)).abs().max())

    # the lockstep stop: rank 3 got the signal; nobody stops off the boundary
    guard = PreemptionGuard(mesh, sync_every=3)
    guard._stop = rank == 3
    out["stop"] = [guard.stop_agreed(i) for i in range(3)] + [guard.stop_agreed(at_epoch_end=True)]

    # KNN: each data rank embeds its shard of every batch; the bank is global
    g = torch.Generator().manual_seed(1)
    bank_x, bank_y = torch.randn(6, 8, 5, generator=g), torch.randint(0, 3, (6, 8), generator=g)
    val_x, val_y = torch.randn(2, 8, 5, generator=g), torch.randint(0, 3, (2, 8), generator=g)
    mine = slice(4 * mesh.index("data"), 4 * mesh.index("data") + 4)
    ev = KNNEvaluator(num_classes=3, k=5, max_bank_size=22, group=data)
    bank, labels = ev.build_bank(lambda t: t, [(bx[mine], by[mine]) for bx, by in zip(bank_x, bank_y)])
    acc = ev.evaluate(lambda t: t, [(bx[mine], by[mine]) for bx, by in zip(bank_x, bank_y)],
                      [(vx[mine], vy[mine]) for vx, vy in zip(val_x, val_y)])
    one = KNNEvaluator(num_classes=3, k=5, max_bank_size=22)
    want_bank, want_labels = one.build_bank(lambda t: t, zip(bank_x, bank_y))
    out["knn"] = (bool(torch.equal(bank, want_bank)), bool(torch.equal(labels, want_labels)), acc,
                  one.evaluate(lambda t: t, zip(bank_x, bank_y), zip(val_x, val_y)))

    # rank 0 writes, every rank reads the same file after the barrier
    path = save_rank0(ckpt_dir, {"step": 7, "rank": torch.tensor(rank)}, 7, mesh)
    out["ckpt"] = (path, int(load_checkpoint(os.path.join(ckpt_dir, "7.pt"))["rank"]))
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return td.launch(_four_ranks, WORLD, str(tmp_path_factory.mktemp("ckpt")))


def test_mesh_coordinates_and_axis_groups(four):
    for rank, out in enumerate(four):
        d, m = divmod(rank, 2)  # row-major: a model group is consecutive ranks
        assert out["coords"] == {"data": d, "model": m}
        assert out["model_ranks"] == [2 * d, 2 * d + 1] and out["data_ranks"] == [m, m + 2]
        assert out["model_sum"] == 4 * d + 1 and out["data_sum"] == 2 * m + 2 and out["world_sum"] == 6


def test_differentiable_all_reduce_sums_forward_and_backward(four):
    # y = Σ_r (r+1)(r+2) = 2+6+12+20; dy/dx_r summed over every rank's loss
    for rank, out in enumerate(four):
        y, grad = out["allreduce"]
        assert y == 40.0
        assert grad == (rank + 2) * sum(10.0 + r for r in range(WORLD))


def test_megatron_operators(four):
    for out in four:
        assert out["f"] == (2.0, 1.0 + 2.0)  # identity forward, gradients summed over the model group
        assert out["g"] == (3.0, 3.0)        # sum forward, identity backward


def test_row_gather_keeps_rank_order_with_unequal_rows(four):
    want = [float(10 * r + i) for r in range(WORLD) for i in range(r + 1)]
    assert all(out["gathered"] == want for out in four)
    assert all(out["tp_gather"] for out in four)


def test_global_batchnorm_equals_one_process_on_the_whole_batch(four):
    for out in four:
        bn = out["bn"]
        assert max(bn.values()) < 1e-5, bn


def test_lars_uses_whole_norms_of_sharded_weights(four):
    assert all(out["lars"] < 1e-7 for out in four)


def test_stop_is_agreed_only_at_lockstep_points(four):
    assert all(out["stop"] == [False, False, True, True] for out in four)


def test_knn_bank_gathers_every_rank_in_order(four):
    for out in four:
        bank_eq, labels_eq, acc, want = out["knn"]
        assert bank_eq and labels_eq and acc == want


def test_rank0_writes_the_checkpoint_the_others_read(four):
    paths = [out["ckpt"][0] for out in four]
    assert paths[0].endswith("7.pt") and paths[1:] == ["", "", ""]
    assert all(out["ckpt"][1] == 0 for out in four)


def test_initialize_uses_the_existing_group_and_refuses_another_rank():
    """A second call in a rank returns the group it joined; a layout that
    names another rank raises."""
    results = td.launch(_reinit, 2)
    assert [r[:2] for r in results] == [(0, "gloo"), (1, "gloo")]
    assert all("already initialized" in r[2] for r in results)


def _reinit():
    import torch.distributed as dist

    again = pm.initialize_distributed("cpu")
    env = {"RANK": str(1 - dist.get_rank()), "WORLD_SIZE": "2", "MASTER_ADDR": "h", "MASTER_PORT": "1"}
    try:
        pm.initialize_distributed("cpu", env=env, timeout=datetime.timedelta(seconds=1))
    except RuntimeError as e:
        return again.rank, again.backend, str(e)
    return again.rank, again.backend, ""
