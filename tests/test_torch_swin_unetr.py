"""Swin UNETR in the port (``models/swin_unetr.py`` through
``Segmentation3DTask(arch="swin_unetr")``) against the plain float32
statement of ``tests/plain_swin_unetr.py``, at feature size 12 on seeded
weights: on two 32³ crops stage 1 pads 16³ tokens to 21³ (window 7, shifted
and unshifted blocks), stage 2 pads 8³ to 14³, stage 3 shrinks the window
to 4³ (its bias read from the 7³ index's ``[:64, :64]``) and stage 4 to
2³, and the bottleneck is one voxel, which its InstanceNorm zeroes; on
one 64³ crop stage 3 pads 8³ to 14³ and stage 4 shrinks to 4³.

This file imports no JAX, so that it also runs on a machine with a card and
without JAX: ``python -m pytest --noconftest tests/test_torch_swin_unetr.py -q``.
Tests that need the card are marked ``gpu`` and skip without one.

Tolerances, all in float32 on the CPU, where both sides differ only in
the order of their sums (convolution algorithms, the fused attention
against explicit products, ``F.instance_norm`` against the port's
statistics on the channels-last view): logits and loss within 1e-5 of the
largest magnitude; the AdamW step exactly torch's formula on the same
gradients, within 1e-6 of each tensor's largest magnitude. Each gradient
within 1e-4 of its own largest magnitude on 32³ crops and 5e-3 on 64³,
where the backward passes through the 2³ bottleneck's InstanceNorms (8
voxels a channel), whose invstd magnifies float32 rounding: both float32
sides read 1.2e-3 to 2.7e-3 from a float64 evaluation of the reference
there, on every leaf alike; or within 1e-6 of the network's largest
gradient, for encoder1's 1³ conv of one input channel, whose output the
norm after it takes back to its sign but for the norm's eps (a gradient of
~1e-5 of the largest). The key projection's bias moves every score of a
query alike, which the softmax takes away: its gradient is 0 in exact
arithmetic and rounding noise on both sides, so those 1/3 of
``attn.qkv.bias`` are held to be nought (under 1e-5 of the layer's largest
gradient) instead.
"""

import argparse
import itertools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import plain_swin_unetr as ref
from medical_image_segmentation_tpu_torch.core import profiling
from medical_image_segmentation_tpu_torch.models import swin_unetr as sw
from medical_image_segmentation_tpu_torch.models.plain_unet3d import InstanceNorm3D
from medical_image_segmentation_tpu_torch.ops import dice
from medical_image_segmentation_tpu_torch.ops import instance_norm as inn
from medical_image_segmentation_tpu_torch.train import train_segmentation3d
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

torch.set_num_threads(4)

F_SIZE = 12
CFG = dict(feature_size=F_SIZE, classes=3, window=7, in_channels=1, depths=[2, 2, 2, 2], heads=[3, 6, 12, 24],
           learning_rate=1e-3, weight_decay=1e-5, betas=(0.9, 0.999), adam_eps=1e-8, warmup_epochs=2,
           max_epochs=10, steps_per_epoch=1)


def _close(got, want, rtol, atol=0.0):
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= max(rtol * scale, atol), err / scale


def _net(seed=0):
    net = sw.SwinUNETR3D(1, 3, F_SIZE).to(memory_format=torch.channels_last_3d)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # the LayerNorms off their init, so that their scale and shift are read
        for name, p in net.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))))
    return net


def _batch(crop, seed=3, batch=2):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, crop, crop, crop, 1, generator=g)
    ax = torch.arange(crop, dtype=torch.float32)
    d, h, w = torch.meshgrid(ax, ax, ax, indexing="ij")
    labels = torch.zeros(batch, crop, crop, crop, 1)
    for b in range(batch):
        c = crop * (0.3 + 0.4 * torch.rand(3, generator=g))
        r2 = (d - c[0]) ** 2 + (h - c[1]) ** 2 + (w - c[2]) ** 2
        labels[b, ..., 0] = (r2 < (crop / 4) ** 2).float() + (r2 < (crop / 10) ** 2).float()
    return x, labels


def _weights(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _grad_close(name, g, w, rtol, atol=0.0):
    """``g`` against ``w``; of a qkv bias the key part held to be nought on
    both sides and the rest compared."""
    if name.endswith("attn.qkv.bias"):
        c = g.shape[0] // 3
        scale = float(w.abs().max())
        assert float(g[c:2 * c].abs().max()) <= 1e-5 * scale and float(w[c:2 * c].abs().max()) <= 1e-5 * scale
        g, w = torch.cat([g[:c], g[2 * c:]]), torch.cat([w[:c], w[2 * c:]])
    if not bool(w.any()):  # a path the one-voxel bottleneck's norm zeroes (32³ crops)
        assert float(g.abs().max()) == 0.0, name
        return
    _close(g, w, rtol, atol)


@pytest.fixture(scope="module", params=[32, 64])
def stepped(request):
    """The port's and the reference's logits, loss and gradients on one
    batch of crops of the given size."""
    crop = request.param
    net = _net()
    x, labels = _batch(crop, batch=2 if crop == 32 else 1)
    P = _weights(net)
    logits = net(x)
    loss = dice.dice_ce_softmax(logits, labels)
    net.zero_grad()
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
    with torch.no_grad():
        want = ref.forward(x, P, CFG)
    ref_loss, ref_grads = ref.loss_and_grads(P, x, labels, CFG)
    return dict(crop=crop, logits=logits.detach(), want=want, loss=loss.detach(), ref_loss=ref_loss, grads=grads,
                ref_grads=ref_grads, net=net, x=x, labels=labels)


def test_the_logits(stepped):
    assert stepped["logits"].shape == (stepped["x"].shape[0], stepped["crop"], stepped["crop"], stepped["crop"], 3)
    assert stepped["logits"].dtype == torch.float32
    _close(stepped["logits"], stepped["want"], 1e-5)


def test_the_loss(stepped):
    assert abs(float(stepped["loss"]) - float(stepped["ref_loss"])) <= 1e-5 * abs(float(stepped["ref_loss"]))


def test_every_gradient(stepped):
    grads, want = stepped["grads"], stepped["ref_grads"]
    assert set(grads) == set(want)
    rtol = {32: 1e-4, 64: 5e-3}[stepped["crop"]]
    largest = max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        _grad_close(name, g, want[name], rtol, 1e-6 * largest)


def test_one_task_step_is_adamw_at_the_schedules_rate():
    """The task's step: its gradients against the reference's, then AdamW
    (lr at the step's epoch, betas, eps, decay, bias correction) applied to
    them as torch's formula states, over two steps."""
    task = Segmentation3DTask(arch="swin_unetr", n_classes=3, feature_size=F_SIZE,
                              learning_rate=CFG["learning_rate"], weight_decay=CFG["weight_decay"],
                              warmup_epochs=CFG["warmup_epochs"], max_epochs=CFG["max_epochs"],
                              steps_per_epoch=1, dtype=torch.float32, device="cpu")
    task.model.load_state_dict(_net().state_dict())
    assert isinstance(task.optimizer, torch.optim.AdamW)
    task.step = 2  # the end of warmup: lr at its base
    P, state = _weights(task.model), {}
    x, labels = _batch(32)
    for k in range(2):
        out = task.train_step(x, labels)
        assert out["lr"] == pytest.approx(ref.lr_at(CFG, 2 + k))
        grads = {n: p.grad for n, p in task.model.named_parameters()}
        loss, want = ref.loss_and_grads(P, x, labels, CFG)
        assert abs(float(out["train/loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
        largest = max(float(w.abs().max()) for w in want.values())
        table = "swinViT.layers1.0.blocks.1.attn.relative_position_bias_table"
        _grad_close(table, grads[table], want[table], 1e-4, 1e-6 * largest)
        P = ref.adamw(P, grads, state, ref.lr_at(CFG, 2 + k), CFG)
        for name, p in task.model.named_parameters():
            _close(p.detach(), P[name], 1e-6)
    assert [task.schedule(k) for k in range(12)] == pytest.approx([ref.lr_at(CFG, k) for k in range(12)])
    assert task.schedule(0) == 0.0 and task.schedule(CFG["max_epochs"]) == pytest.approx(0.0, abs=1e-12)


def test_the_state_dict_names_are_monais():
    net = sw.SwinUNETR3D(1, 3, 48)
    names = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert names == ref.layout({**CFG, "feature_size": 48})
    for name in ("swinViT.patch_embed.proj.weight", "swinViT.layers1.0.blocks.0.attn.relative_position_bias_table",
                 "swinViT.layers1.0.blocks.0.attn.relative_position_index",
                 "swinViT.layers2.0.blocks.1.mlp.linear2.bias",
                 "swinViT.layers4.0.downsample.reduction.weight", "encoder1.layer.conv1.conv.weight",
                 "encoder1.layer.conv3.conv.weight", "encoder10.layer.conv2.conv.weight",
                 "decoder5.transp_conv.conv.weight", "decoder1.conv_block.conv3.conv.weight", "out.conv.conv.bias"):
        assert name in names, name
    assert "encoder2.layer.conv3.conv.weight" not in names and not any("norm1.weight" in k and "encoder" in k
                                                                        for k in names)
    assert sum(v.numel() for v in net.parameters()) == 62_186_757
    assert names["swinViT.layers3.0.blocks.0.attn.relative_position_bias_table"] == (13 ** 3, 12)


def test_patch_merging_takes_the_sub_grids_in_product_order():
    m = sw.PatchMerging(1)
    with torch.no_grad():
        m.norm.weight.fill_(1.0)
        m.norm.bias.zero_()
        m.reduction.weight.copy_(torch.eye(2, 8))
    x = torch.arange(2 * 4 * 4 * 4, dtype=torch.float32).view(2, 4, 4, 4, 1)
    cat = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in itertools.product(range(2), repeat=3)], dim=-1)
    assert torch.equal(cat[0, 0, 0, 0], torch.tensor([0.0, 1.0, 4.0, 5.0, 16.0, 17.0, 20.0, 21.0]))
    normed = F.layer_norm(cat, (8,), eps=sw.LN_EPS)
    with torch.no_grad():
        _close(m(x), normed[..., :2], 1e-6)


def test_a_shrunken_window_reads_the_full_indexs_corner():
    idx7 = sw.relative_position_index(7)
    assert torch.equal(idx7, ref.relative_position_index(7)) and idx7.shape == (343, 343)
    attn = sw.WindowAttention(24, 2, 7)
    torch.nn.init.normal_(attn.relative_position_bias_table, generator=torch.Generator().manual_seed(5))
    n = 64  # a 4³ window
    seen = {}
    orig = F.scaled_dot_product_attention

    def spy(q, k, v, attn_mask=None, **kw):
        seen["bias"] = attn_mask
        return orig(q, k, v, attn_mask=attn_mask, **kw)

    x = torch.randn(3, n, 24)
    torch.nn.functional.scaled_dot_product_attention = spy
    try:
        attn(x, 3, None)
    finally:
        torch.nn.functional.scaled_dot_product_attention = orig
    want = attn.relative_position_bias_table[idx7[:n, :n].reshape(-1)].view(n, n, 2).permute(2, 0, 1)
    assert torch.equal(seen["bias"][0], want.detach())
    # the corner of the 7³ index is not the 4³ window's own index
    assert not torch.equal(idx7[:n, :n], sw.relative_position_index(4))


def _block_case(seed=7):
    blk = sw.SwinBlock(12, 3, 7, 3)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return blk, torch.randn(1, 16, 16, 16, 12, generator=g)


def _explicit_block_attention(blk, x, mask_pads: bool):
    """The block's window attention written out, its pad tokens attended
    or (``mask_pads``) masked off."""
    P = {f"b.{k}": v for k, v in blk.state_dict().items()}
    u = F.layer_norm(x, (12,), P["b.norm1.weight"], P["b.norm1.bias"], eps=sw.LN_EPS)
    if not mask_pads:
        return ref._attention(u, P, "b", 3, 7, 3)
    real = F.pad(torch.ones(1, 16, 16, 16, 1), (0, 0, 0, 5, 0, 5, 0, 5))
    real = torch.roll(real, shifts=(-3, -3, -3), dims=(1, 2, 3))
    keep = ref._windows(real, [7, 7, 7])[0, :, :, 0]  # (windows, n)
    saved = ref.shift_mask

    def masked(dims, ws, ss, device):
        return saved(dims, ws, ss, device) + torch.where(keep[:, None, :] > 0, 0.0, -1e9)

    ref.shift_mask = masked
    try:
        return ref._attention(u, P, "b", 3, 7, 3)
    finally:
        ref.shift_mask = saved


def test_the_pad_tokens_are_attended():
    blk, x = _block_case()
    with torch.no_grad():
        blk.mlp.linear2.weight.zero_()
        blk.mlp.linear2.bias.zero_()
        got = blk(x) - x  # the attention's residual alone
        attended = _explicit_block_attention(blk, x, False)
        masked = _explicit_block_attention(blk, x, True)
    _close(got, attended, 1e-5)
    assert float((attended - masked).abs().max()) > 100 * 1e-5 * float(attended.abs().max())


def test_the_shift_mask_is_minus_100_between_regions():
    dims, ws, ss = (14, 14, 14), (7, 7, 7), (3, 3, 3)
    mask = sw.shift_mask(dims, ws, ss, "cpu")
    assert mask.shape == (8, 343, 343) and set(mask.unique().tolist()) == {0.0, -100.0}
    coords = torch.tensor(list(itertools.product(range(7), repeat=3)))
    for win, origin in enumerate(itertools.product((0, 7), repeat=3)):
        region = [(torch.as_tensor(o) + coords[:, a] >= 14 - 3).long() * (o > 0) for a, o in enumerate(origin)]
        ids = region[0] * 9 + region[1] * 3 + region[2]
        want = torch.where(ids[:, None] == ids[None, :], 0.0, -100.0)
        assert torch.equal(mask[win], want), win
    assert torch.equal(mask, ref.shift_mask(dims, ws, ss, "cpu"))
    assert not bool(mask[0].any())  # the first window holds one region


def test_the_counters_count_the_padded_tokens_once():
    net = _net()
    x, labels = _batch(32)
    # crops of 32³: 16³ → 21³, 8³ → 14³, 4³ and 2³ unpadded; two blocks a stage, two crops
    tokens = 2 * 2 * (21 ** 3 + 14 ** 3 + 4 ** 3 + 2 ** 3)
    pads = 2 * 2 * (21 ** 3 - 16 ** 3 + 14 ** 3 - 8 ** 3)
    for remat in (False, True):
        net.remat = remat
        profiling.reset_counters()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            dice.dice_ce_softmax(net(x), labels).backward()
        c = profiling.counters()
        assert (c["swin.attention_tokens"], c["swin.attention_pad_tokens"]) == (tokens, pads), remat
        names = {e.name for e in prof.events()}
        assert {"mis.swin.attention", "mis.swin.encoder", "mis.norm.instance"} <= names
    profiling.reset_counters()
    # at the cell's 96³ crops, 4 a step: 49³, 28³, 14³, 6³ tokens a block
    assert 4 * 2 * (49 ** 3 + 28 ** 3 + 14 ** 3 + 6 ** 3) == 1_140_488
    assert 4 * 2 * (49 ** 3 - 48 ** 3 + 28 ** 3 - 24 ** 3 + 14 ** 3 - 12 ** 3) == 129_608


def test_remat_gives_the_same_gradients():
    x, labels = _batch(32)
    plain, remat = _net(), _net()
    remat.remat = True
    for net in (plain, remat):
        dice.dice_ce_softmax(net(x), labels).backward()
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        _grad_close(name, b.grad, a.grad, 1e-5)


def test_the_loss_against_monais_statement():
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(3, 5, 6, 4, 3, generator=g)
    labels = torch.randint(0, 3, (3, 5, 6, 4, 1), generator=g).float()
    got = dice.dice_ce_softmax(logits, labels)
    p = torch.softmax(logits, -1).reshape(3, -1, 3)
    y = F.one_hot(labels.reshape(3, -1).long(), 3).float()
    d = 1 - 2 * (p * y).sum(1) / ((p ** 2).sum(1) + (y ** 2).sum(1) + 1e-6)
    want = d.mean() + F.cross_entropy(logits.reshape(-1, 3), labels.reshape(-1).long())
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(ref.dice_ce(logits, labels)) == pytest.approx(float(want), rel=1e-6)


def test_crops_off_the_stride_and_wrong_recipes_are_refused():
    net = sw.SwinUNETR3D(1, 3, F_SIZE)
    with pytest.raises(ValueError, match="multiples of 32"):
        net(torch.zeros(1, 32, 48, 32, 1))
    task = Segmentation3DTask(arch="swin_unetr", n_classes=3, feature_size=F_SIZE, loss="dice", device="cpu")
    assert task._loss is dice.dice_ce_softmax and isinstance(task.optimizer, torch.optim.AdamW)  # the arch's recipe
    with pytest.raises(ValueError, match="depth sharding"):
        Segmentation3DTask(arch="swin_unetr", n_classes=3, feature_size=F_SIZE, device="cpu",
                           mesh=argparse.Namespace(size=lambda axis: 2, group=lambda axis: None))


def test_the_cli_takes_the_recipe_and_refuses_by_name(capsys):
    base = ["--images_dir", "a", "--masks_dir", "b"]
    args = train_segmentation3d.parse_args(base + ["--arch", "swin_unetr", "--classes", "3"])
    assert (args.learning_rate, args.weight_decay) == (1e-4, 1e-5)
    assert (args.warmup_epochs, args.max_epochs, args.min_lr) == (50, 5000, 0.0)
    plain = train_segmentation3d.parse_args(base)
    assert (plain.features, plain.warmup_epochs, plain.max_epochs, plain.min_lr) == ((32, 64, 128, 256), 10, 50, 1e-2)
    nn_args = train_segmentation3d.parse_args(base + ["--arch", "nnunet3d", "--classes", "3"])
    assert (nn_args.warmup_epochs, nn_args.max_epochs, nn_args.min_lr) == (10, 50, 1e-2)
    for extra, flag in ((["--features", "8", "16"], "--features"), (["--loss", "dice_ce"], "--loss"),
                        (["--space_shards", "2"], "--space_shards"),
                        (["--ssl_checkpoint", "c"], "--ssl_checkpoint"),
                        (["--full_res_window", "32", "32", "32"], "--full_res_window")):
        with pytest.raises(SystemExit):
            train_segmentation3d.parse_args(base + ["--arch", "swin_unetr", "--classes", "3"] + extra)
        assert f"--arch swin_unetr does not support {flag}" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train_segmentation3d.parse_args(base + ["--arch", "swin_unetr"])
    assert "--classes of at least 2" in capsys.readouterr().err


def test_the_cli_trains_swin_unetr_on_decathlon_label_maps(tmp_path):
    from medical_image_segmentation_tpu_torch.data.nifti import write_nifti

    img_dir, lab_dir = tmp_path / "imagesTr", tmp_path / "labelsTr"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        vol = (rng.normal(size=(36, 36, 34)) * 100).astype(np.int16)
        lab = np.zeros((36, 36, 34), np.uint8)
        lab[8:26, 9:27, 6:24] = 1
        lab[14:19, 15:20, 12:17] = 2
        write_nifti(str(img_dir / f"liver_{i}.nii.gz"), vol)
        write_nifti(str(lab_dir / f"liver_{i}.nii.gz"), lab)
    run = train_segmentation3d.run([
        "--images_dir", str(img_dir), "--masks_dir", str(lab_dir), "--arch", "swin_unetr", "--classes", "3",
        "--volume_size", "32", "36", "36", "--crop_size", "32", "32", "32",
        "--batch_size", "1", "--max_epochs", "1", "--warmup_epochs", "0", "--limit_steps_per_epoch", "1",
        "--eval_every_epochs", "0", "--device", "cpu", "--fp32", "--skip_hbm_check",
        "--log_dir", str(tmp_path / "logs"), "--checkpoint_dir", str(tmp_path / "ckpt")])
    assert isinstance(run.task.model, sw.SwinUNETR3D) and run.task.model.out.conv.conv.out_channels == 3
    assert run.task.model.feature_size == 48
    assert isinstance(run.task.optimizer, torch.optim.AdamW)
    assert len(run.losses) == 1 and math.isfinite(float(run.losses[0]))
    assert [lr for _, lr in run.schedule] == pytest.approx([1e-4])
    assert 0.0 <= run.test["test/dice"] <= 1.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written InstanceNorm kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 48, 20, 20, 20), (2, 96, 6, 6, 6)])
@pytest.mark.parametrize("affine, slope", [(False, 0.01), (False, 1.0), (True, 1.0)])
def test_instance_norm_without_affine_or_activation_on_card(cuda, shape, affine, slope):
    """The kernels at slope 1 and with the fixed scale and shift against the
    plain float32 function on the CPU. Their statistics are float32 sums in
    another order, so the bf16 outputs may round apart: the forward within
    one bf16 ulp at each magnitude (2^-7 of it) and 1e-5 besides, the
    gradients within 2^-7 of the largest."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=g) * 2 + 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    dy = torch.randn(shape, generator=g).to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    cpu = InstanceNorm3D(shape[1], affine=affine, slope=slope)
    card = InstanceNorm3D(shape[1], affine=affine, slope=slope).to(cuda)
    assert (len(list(cpu.parameters())) == 2) == affine and ("weight" in cpu.state_dict()) == affine
    xc, xg = x.clone().requires_grad_(), x.to(cuda).requires_grad_()
    yc, yg = cpu(xc), card(xg)
    before = inn.launches
    yc.backward(dy)
    yg.backward(dy.to(cuda))
    assert inn.launches == before + inn.launches_per_call(xg)
    want = yc.detach().float()
    assert bool(((yg.detach().cpu().float() - want).abs() <= 2.0 ** -7 * want.abs() + 1e-5).all())
    _close(xg.grad.cpu().float(), xc.grad.float(), 2.0 ** -7)
    if slope == 1.0:  # no activation: the normalized values themselves
        var, mean = torch.var_mean(x.float(), dim=(2, 3, 4), keepdim=True, correction=0)
        _close(yg.detach().cpu().float(), (x.float() - mean) / (var + 1e-5).sqrt(), 2.0 ** -7)


@pytest.mark.gpu
def test_a_swin_step_on_card_follows_the_cpu_step(cuda):
    """A bf16 autocast step on the card against the float32 step on the
    CPU at feature size 12 on 32³ crops: the loss within 2e-2 of it, the
    InstanceNorms on the kernels (3 a call above 1,024 voxels a sample, 1 at
    or below, each way)."""
    net = _net()
    x, labels = _batch(32)
    with torch.no_grad():
        want = float(dice.dice_ce_softmax(net(x), labels))
    card = _net().to(cuda)
    norms = [m for m in card.modules() if isinstance(m, InstanceNorm3D)]
    shapes = []
    hooks = [m.register_forward_hook(lambda m, a, o: shapes.append(a[0].shape)) for m in norms]
    before = inn.launches
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss = dice.dice_ce_softmax(card(x.to(cuda)), labels.to(cuda))
    loss.backward()
    for h in hooks:
        h.remove()
    stated = sum(inn.launches_per_call(torch.empty(s, device="meta")) for s in shapes)
    assert len(shapes) == 26 and inn.launches - before == 2 * stated
    assert abs(float(loss) - want) <= 2e-2 * abs(want)
    assert all(torch.isfinite(p.grad).all() for p in card.parameters())
