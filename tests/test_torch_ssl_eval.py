"""The port's SSL evaluation parts against the JAX package's, on the CPU:
the host-pre-crop augmentation tail, ``BYOLTask.embed_step``, the KNN
probe and the linear probe, plus ``mis-linear-probe-torch`` on a tiny
labelled store.

Inputs are made with numpy from a seed and handed to both packages; the
JAX tail's draws are injected into the port (``apply_view_tail``), and the
networks and the probe head start from JAX's weights through
``core/convert.py``.

Tolerances. The tail rounds once from f32: bf16 outputs within 1 bf16 ulp
(the two frameworks may round the f32 quotient to neighbouring values),
f32 within 1e-5. ``embed_step``: 1e-4 of the largest feature, the
tolerance of ``test_torch_models.py`` for ResNet-18. KNN scores: rel 1e-5
(sums of up to k exponentials in another order); the inputs are drawn
from a continuous distribution, so no two similarities tie and the
top-k sets agree. The linear probe: rel 1e-5 after 5 Adam steps.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medical_image_segmentation_tpu.eval.knn import knn_predict as jax_knn_predict
from medical_image_segmentation_tpu.eval.knn import knn_predict_chunked as jax_knn_predict_chunked
from medical_image_segmentation_tpu.eval.linear_probe import LinearProbe as JaxLinearProbe
from medical_image_segmentation_tpu.ops import augment as jaug
from medical_image_segmentation_tpu.train.byol_task import BYOLTask as JaxBYOLTask
from medical_image_segmentation_tpu_torch.core.convert import flax_to_state_dict, probe_flax_to_state_dict
from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter
from medical_image_segmentation_tpu_torch.eval import knn as tknn
from medical_image_segmentation_tpu_torch.eval import run_linear_probe
from medical_image_segmentation_tpu_torch.eval.linear_probe import LinearProbe
from medical_image_segmentation_tpu_torch.ops import augment as taug
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask

torch.set_num_threads(2)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place (sign-magnitude bit
    patterns mapped onto a monotone integer line)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i + 32768))

    return int((ordered(a) - ordered(b)).abs().max())


# ------------------------------------------------------ pre-crop tail


def _jax_tail_draws(key, b, c, cfg):
    """The draws JAX's ``augment_view_tail`` makes from ``key``, named as
    ``sample_tail_draws`` names them (``ops/augment.py:228-275, 320``)."""
    keys = jax.random.split(key, 4)
    u = lambda k, lo=0.0, hi=1.0: np.asarray(jax.random.uniform(k, (b, 1, 1, 1), minval=lo, maxval=hi)).reshape(b)
    d = {}
    if cfg.grayscale_prob > 0.0 and c == 3:
        d["gray"] = u(keys[1]) < cfg.grayscale_prob
    if cfg.window_prob > 0.0:
        wk = jax.random.split(keys[3], 3)
        d["window_on"] = u(wk[0]) < cfg.window_prob
        d["level"] = u(wk[1], *cfg.window_level_range)
        d["width"] = u(wk[2], *cfg.window_width_range)
    if cfg.solarize_prob > 0.0:
        d["solarize"] = u(keys[2]) < cfg.solarize_prob
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


# (channels, window_prob, solarize_prob)
TAIL_CASES = [(1, 0.0, 0.0), (1, 0.7, 0.5), (3, 0.0, 0.0), (3, 0.7, 0.5)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("channels,window,solarize", TAIL_CASES)
def test_two_view_tail_matches_jax(channels, window, solarize, dtype):
    b, s = 6, 16
    views = np.random.default_rng(channels).integers(0, 256, size=(2 * b, s, s, channels)).astype(np.uint8)
    mean, std = (57.9764,) * channels, (60.4759,) * channels
    changes = dict(out_size=(s, s), window_prob=window, solarize_prob=solarize, grayscale_prob=0.5)
    jc = [dataclasses.replace(getattr(jaug, f"BYOL_VIEW{i}"), **changes) for i in (1, 2)]
    tc = [dataclasses.replace(getattr(taug, f"BYOL_VIEW{i}"), **changes) for i in (1, 2)]
    key = jax.random.key(11 + channels)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jaug.two_view_tail_augment(key, jnp.asarray(views), *jc, mean=mean, std=std, dtype=jdt)
    tviews = torch.from_numpy(views)
    for v, (kv, jcfg, tcfg, w) in enumerate(zip(jax.random.split(key), jc, tc, want)):
        got = taug.apply_view_tail(_jax_tail_draws(kv, b, channels, jcfg), tviews[v::2], tcfg, mean, std, tdt)
        w = torch.from_numpy(np.array(w.astype(jnp.float32))).to(tdt)
        assert got.shape == w.shape == (b, s, s, channels) and got.dtype == tdt
        if dtype == "bfloat16":
            assert bf16_ulps(got, w) <= 1
        else:
            np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-5, rtol=0)


def test_two_view_tail_draws_from_generator_and_pairs_sample_major():
    """Rows 2i and 2i+1 are sample i's two views; the generator supplies
    the draws; a blur recipe is refused as in JAX."""
    views = torch.from_numpy(np.random.default_rng(0).integers(0, 256, size=(8, 12, 12, 1)).astype(np.uint8))
    cfg = dataclasses.replace(taug.BYOL_VIEW1, out_size=(12, 12), grayscale_prob=0.0)
    v1, v2 = taug.two_view_tail_augment(torch.Generator().manual_seed(0), views, cfg, cfg, dtype=torch.float32)
    # no random op is on: each view is its rows, normalized
    np.testing.assert_allclose(v1.numpy(), ((views[0::2].float() - 57.9764) / 60.4759).numpy(), atol=1e-6)
    np.testing.assert_allclose(v2.numpy(), ((views[1::2].float() - 57.9764) / 60.4759).numpy(), atol=1e-6)
    sol = dataclasses.replace(cfg, solarize_prob=0.5)
    a = taug.two_view_tail_augment(torch.Generator().manual_seed(3), views, sol, sol)
    b = taug.two_view_tail_augment(torch.Generator().manual_seed(3), views, sol, sol)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    blur = dataclasses.replace(cfg, blur_prob=0.5)
    assert not taug.precrop_supported(blur) and taug.precrop_supported(cfg)
    with pytest.raises(ValueError, match="blur_prob"):
        taug.two_view_tail_augment(torch.Generator().manual_seed(0), views, blur, cfg)
    with pytest.raises(ValueError, match="2 views per sample"):
        taug.two_view_tail_augment(torch.Generator().manual_seed(0), views[:3], cfg, cfg)


def test_sample_view_draws_keep_their_stream():
    """The tail's draws moved into ``sample_tail_draws``: the full view's
    draws are still the geometry's followed by the tail's."""
    cfg = dataclasses.replace(taug.BYOL_TV_VIEW2, window_prob=0.4, grayscale_prob=0.3)
    full = taug.sample_view_draws(torch.Generator().manual_seed(5), 7, 40, 40, 3, cfg)
    g = torch.Generator().manual_seed(5)
    geo = [taug._uniform(g, 7) for _ in range(5)]  # area, aspect, y0, x0, flip
    blur = [taug._uniform(g, 7) for _ in range(4)]
    tail = taug.sample_tail_draws(g, 7, 3, cfg)
    assert torch.equal(full["flip"], geo[4] < cfg.hflip_prob)
    assert torch.equal(full["blur_coin_x"], blur[3] < cfg.blur_prob)
    assert set(tail) < set(full) and all(torch.equal(full[k], v) for k, v in tail.items())


# ------------------------------------------------------------ embed_step


@pytest.mark.parametrize("channels,low_res,size", [(1, False, 32), (3, True, 32)])
def test_embed_step_matches_jax(channels, low_res, size):
    kw = dict(arch="resnet18", in_channels=channels, low_res=low_res, hidden_dim=32, proj_dim=16, num_classes=5)
    jt = JaxBYOLTask(dtype=jnp.float32, **kw)
    state = jt.init(jax.random.key(3), (2, size, size, channels))
    task = BYOLTask(dtype=torch.float32, device="cpu", **kw)
    task.online.load_state_dict(flax_to_state_dict(jax.device_get(state.params), jax.device_get(state.batch_stats)))
    # running statistics away from their init, so eval mode is tested
    with torch.no_grad():
        for name, buf in task.online.named_buffers():
            buf.copy_(torch.linspace(0.5, 1.5, buf.numel()).view_as(buf))
    jstats = _stats_to_flax(task.online, jax.device_get(state.batch_stats))
    x = np.random.default_rng(2).standard_normal((4, size, size, channels)).astype(np.float32)
    want = np.asarray(jt.embed_step(state.replace(batch_stats=jstats), jnp.asarray(x)))
    got = task.embed_step(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (4, 512)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert task.online.training  # back in train mode


def _stats_to_flax(online, like):
    """``like`` (a flax ``batch_stats`` tree) with the values of the
    port module's running statistics, through the converter's names."""
    from medical_image_segmentation_tpu_torch.core.convert import torch_name

    sd = online.state_dict()

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = walk(v, path + "/")
            else:
                name, _ = torch_name(path)
                out[k] = jnp.asarray(sd[name].numpy())
        return out

    return walk(like, "")


# ------------------------------------------------------------------ KNN


def _knn_inputs(seed=7, n=1000, d=16, b=8, classes=5):
    rng = np.random.default_rng(seed)
    bank = rng.normal(size=(n, d)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    return bank, rng.integers(0, classes, size=n), rng.normal(size=(b, d)).astype(np.float32)


@pytest.mark.parametrize("k", [50, 200])
def test_knn_predict_matches_jax(k):
    bank, labels, q = _knn_inputs()
    want = np.asarray(jax_knn_predict(jnp.asarray(q), jnp.asarray(bank), jnp.asarray(labels), num_classes=5, k=k))
    got = tknn.knn_predict(torch.from_numpy(q), torch.from_numpy(bank), torch.from_numpy(labels), 5, k=k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("chunk", [64, 300, 333, 4096])
def test_knn_predict_chunked_matches_unchunked_and_jax(chunk):
    """Chunk sizes that do and do not divide the bank, and one larger than
    it (``tests/test_tasks.py:243-262``)."""
    bank, labels, q = _knn_inputs()
    args = (torch.from_numpy(q), torch.from_numpy(bank), torch.from_numpy(labels), 5)
    full = tknn.knn_predict(*args, k=50).numpy()
    got = tknn.knn_predict_chunked(*args, k=50, chunk_size=chunk).numpy()
    want = np.asarray(jax_knn_predict_chunked(jnp.asarray(q), jnp.asarray(bank), jnp.asarray(labels),
                                              num_classes=5, k=50, chunk_size=chunk))
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_knn_evaluator_cap_and_chunks_match_jax():
    """The bank cap truncates mid-batch; the chunked evaluator gives JAX's
    accuracy on the same noisy three-class problem."""
    from medical_image_segmentation_tpu.eval.knn import KNNEvaluator as JaxKNNEvaluator

    rng = np.random.default_rng(8)
    centers = np.eye(3, dtype=np.float32) * 2
    ys = rng.integers(0, 3, size=120)
    feats = centers[ys] + rng.normal(scale=1.0, size=(120, 3)).astype(np.float32)
    train = [(feats[i:i + 30], ys[i:i + 30]) for i in (0, 30, 60)]
    val = [(feats[90:], ys[90:])]
    kw = dict(num_classes=3, k=10, max_bank_size=45, bank_chunk_size=16)
    want = JaxKNNEvaluator(**kw).evaluate(lambda x: x, train, val)
    ev = tknn.KNNEvaluator(**kw)
    tt = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in train]
    bank, _ = ev.build_bank(lambda x: x, tt)
    assert bank.shape == (45, 3)
    got = ev.evaluate(lambda x: x, tt, [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in val])
    assert got == want and 0.5 < got < 1.0


# ---------------------------------------------------------- linear probe


def test_linear_probe_five_adam_steps_match_jax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(5, 16, 32)).astype(np.float32)
    labels = rng.integers(0, 4, size=(5, 16)).astype(np.int32)
    jp = JaxLinearProbe(feature_dim=32, num_classes=4, lr=1e-2)
    js = jp.init(jax.random.key(0))
    probe = LinearProbe(32, 4, lr=1e-2, device="cpu")
    probe.head.load_state_dict(probe_flax_to_state_dict(jax.device_get(js.params)))
    for x, y in zip(feats, labels):
        js, jm = jp.train_step(js, jnp.asarray(x), jnp.asarray(y))
        tm = probe.train_step(torch.from_numpy(x), torch.from_numpy(y))
        assert set(tm) == set(jm) == {"online_train_loss", "online_train_acc"}
        for k in tm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    want = probe_flax_to_state_dict(jax.device_get(js.params))
    for name, p in probe.head.state_dict().items():
        w = want[name].numpy()
        assert np.abs(p.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name
    x, y = torch.from_numpy(feats[0]), torch.from_numpy(labels[0])
    jm, tm = jp.eval_step(js, jnp.asarray(feats[0]), jnp.asarray(labels[0])), probe.eval_step(x, y)
    assert set(tm) == set(jm) == {"online_val_loss", "online_val_acc"}
    for k in tm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5)


def test_adam_update_is_optax_adam():
    """ε outside the square root of the bias-corrected second moment, in
    both: three steps of one parameter on the same gradients. The third
    element's gradients (~1e-8) put √ν̂ next to ε = 1e-8, where ε inside
    the root would change its step ~10⁴-fold. optax computes the bias
    corrections in f32 and torch in f64 (1 − 0.999 differs by 1.3e-5
    relative), so the steps agree to 1e-4, not to f32 rounding."""
    grads = [np.array([0.3, -2.0, 2e-8], np.float32), np.array([0.1, 0.5, -1e-8], np.float32),
             np.array([-0.2, 1.0, 3e-8], np.float32)]
    tx = optax.adam(0.1)
    p = jnp.zeros(3)
    state = tx.init(p)
    t = torch.zeros(3, requires_grad=True)
    opt = torch.optim.Adam([t], lr=0.1)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        t.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(p), rtol=1e-4, atol=0)
    assert abs(float(p[2])) > 1e-3  # the ε-dominated element really moved by a large step


def test_linear_probe_dropout_uses_its_generator():
    x, y = torch.ones(8, 6), torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="generator"):
        LinearProbe(6, 2, dropout=0.5, device="cpu")
    runs = []
    for _ in range(2):
        probe = LinearProbe(6, 2, dropout=0.5, device="cpu", generator=torch.Generator().manual_seed(4))
        probe.init(0)
        probe.train_step(x, y)
        runs.append(probe.head.linear.weight.detach().clone())
    assert torch.equal(*runs)
    # kept values are scaled by 1/(1 - rate), dropped ones are 0
    masked = probe.head(torch.ones(4, 6), torch.Generator().manual_seed(1)) - probe.head.linear.bias
    full = probe.head(torch.ones(4, 6)) - probe.head.linear.bias
    assert not torch.allclose(masked, full)


# ------------------------------------------------ mis-linear-probe-torch


@pytest.fixture(scope="module")
def labelled_stores(tmp_path_factory):
    """CIFAR10-shaped raw stores: 32 train and 16 val 32² RGB images."""
    d = tmp_path_factory.mktemp("c10")
    rng = np.random.default_rng(0)
    for split, n in (("train", 32), ("val", 16)):
        with StoreWriter(str(d / f"{split}.mis"), channels=3, with_labels=True) as w:
            for i in range(n):
                w.add(rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8), label=i % 10, codec=CODEC_RAW)
    return d


def test_linear_probe_cli_runs_on_a_labelled_store(labelled_stores, tmp_path, monkeypatch):
    monkeypatch.setenv("CIFAR10_TRAIN_STORE", str(labelled_stores / "train.mis"))
    monkeypatch.setenv("CIFAR10_VAL_STORE", str(labelled_stores / "val.mis"))
    task = BYOLTask(arch="resnet18", in_channels=3, low_res=True, hidden_dim=32, proj_dim=16, device="cpu")
    task.init(2)
    from medical_image_segmentation_tpu_torch.core.checkpoint import save_checkpoint

    save_checkpoint(str(tmp_path / "ssl"), task.state_dict(), 7)
    out = run_linear_probe.run(["--checkpoint", str(tmp_path / "ssl"), "--dataset", "CIFAR10", "--hidden_dim", "32",
                                "--projection_dim", "16", "--batch_size", "8", "--epochs", "2", "--lr", "1e-2",
                                "--device", "cpu"])
    assert set(out) == {"online_train_acc", "online_val_acc", "online_val_loss"}
    assert 0.0 <= out["online_val_acc"] <= 1.0 and np.isfinite(out["online_val_loss"])
    shutil.rmtree(tmp_path / "ssl")  # a full-size ResNet-18 checkpoint


def test_linear_probe_cli_refuses_an_unlabelled_dataset(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="unlabeled train store"):
        run_linear_probe.main(["--checkpoint", str(tmp_path), "--dataset", "RADIOLOGY_1M", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        run_linear_probe.main(["--checkpoint", str(tmp_path), "--dataset", "CIFAR10"])  # cuda is the default
