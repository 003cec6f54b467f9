"""The port's exported serving artifacts on the CPU: ``serve.py``,
``mis-export-torch`` / ``mis-export3d-torch`` and ``--exported`` of both
predict CLIs. The twin of ``tests/test_serving.py``.

The same weights go into both packages through ``core/convert.py``
(resnet18 U-Net at 64², ``UNet3D`` (4, 8) at 8×16×16, f32); inputs come
from a numpy seed.

- Port artifact against the port's ``make_predict_fn``: equal on every
  pixel for every N from 1 past the largest bucket (buckets 1 and 4): the
  artifact IS that function, captured.
- Port artifact against the JAX package's ``.misx``, each through its own
  ``ServingPredictor``: at least 99.9% of pixels (a logit within f32
  rounding of the threshold may fall either way), both classes present.
- Window artifact logits against the JAX ``export_window_predictor``'s:
  1e-4 of the largest logit, with and without ``hu_windows``.
- The container's refusals, each with its message; both CLI chains against
  the checkpoint-backed run (equal files); the baked-flag refusals; loading
  and calling an artifact imports no model code.
"""

import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_tpu import serve as jserve
from medical_image_segmentation_tpu.train import export as jexport
from medical_image_segmentation_tpu.train import export3d as jexport3d
from medical_image_segmentation_tpu.train import predict as jpredict
from medical_image_segmentation_tpu.train.seg3d_task import Segmentation3DTask as JaxSeg3DTask
from medical_image_segmentation_tpu.train.segmentation_task import SegmentationTask as JaxSegTask
from medical_image_segmentation_tpu_torch import serve
from medical_image_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from medical_image_segmentation_tpu_torch.core.convert import unet3d_flax_to_state_dict, unet_flax_to_state_dict
from medical_image_segmentation_tpu_torch.data.nifti import read_nifti, write_nifti
from medical_image_segmentation_tpu_torch.train import export, export3d, predict, predict3d
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask
from medical_image_segmentation_tpu_torch.utils.png import write_png

torch.set_num_threads(2)

MEAN, STD = 0.2089, 0.2109
WINDOWS = ((0.4, 0.5), (0.7, 0.3))


def _slices(n, size=64, seed=3):
    """Blobs on noise, so that a random-init U-Net gives both classes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = [np.clip(rng.normal(90, 30, (size, size)) + 90 * ((yy - 30) ** 2 + (xx - 12 - 6 * i) ** 2 < 200), 0, 255)
           for i in range(n)]
    return np.stack(out).astype(np.uint8)[..., None]


@pytest.fixture(scope="module")
def unet(tmp_path_factory):
    """One U-Net in both packages, the port's artifact (buckets 1 and 4)
    and its checkpoint."""
    d = tmp_path_factory.mktemp("serve2d")
    jt = JaxSegTask(arch="resnet18", n_classes=1, in_channels=1, learning_rate=1.0, warmup_epochs=0, max_epochs=1,
                    steps_per_epoch=1, dtype=jnp.float32)
    state = jt.init(jax.random.key(0), (2, 64, 64, 1))
    host = jax.device_get(state)
    task = SegmentationTask(dtype=torch.float32, device="cpu")
    task.model.load_state_dict(unet_flax_to_state_dict(host.params, host.batch_stats))
    save_checkpoint(str(d / "ckpt"), {"step": 3, "model": task.model.state_dict()}, 3)
    art = str(d / "m.misx")
    exported = serve.export_predictor(task, 64, MEAN, STD, batch_sizes=(4, 1, 4))
    assert sorted(exported) == [1, 4]  # sorted, de-duplicated
    serve.save_predictor(art, exported, {"kind": "batched2d", "image_size": 64, "platforms": ["cpu"],
                                         "checkpoint_step": 3})
    return dict(jt=jt, state=state, task=task, art=art, ckpt=str(d / "ckpt"), dir=d)


@pytest.fixture(scope="module")
def unet3d(tmp_path_factory):
    """One ``UNet3D`` per input-channel count in both packages."""
    d = tmp_path_factory.mktemp("serve3d")
    out = {"dir": d}
    for in_ch in (1, 2):
        jt = JaxSeg3DTask(in_channels=in_ch, features=(4, 8), norm="group", learning_rate=1.0, warmup_epochs=0,
                          max_epochs=1, steps_per_epoch=1, dtype=jnp.float32)
        state = jt.init(jax.random.key(in_ch), (1, 8, 16, 16, in_ch))
        host = jax.device_get(state)
        task = Segmentation3DTask(in_channels=in_ch, features=(4, 8), dtype=torch.float32, device="cpu")
        task.model.load_state_dict(unet3d_flax_to_state_dict(host.params, host.batch_stats))
        save_checkpoint(str(d / f"ckpt{in_ch}"), {"step": 2, "model": task.model.state_dict()}, 2)
        out[in_ch] = (jt, state, task, str(d / f"ckpt{in_ch}"))
    return out


# ------------------------------------------------------------- the artifact


@pytest.mark.parametrize("n", range(1, 7))
def test_artifact_equals_the_serving_function_for_every_n(unet, n):
    """Exact bucket, small bucket, greedy decomposition (5 = 4 + 1, 6 = 4 +
    1 + 1) and nothing padded beyond the smallest bucket."""
    pred = serve.load_predictor(unet["art"], device="cpu")
    assert pred.batch_sizes == [1, 4] and pred.image_size == 64 and pred.load_seconds == 0.0
    imgs = _slices(n, seed=n)
    got = pred(imgs)
    loaded = pred.load_seconds
    assert loaded > 0.0 and pred(imgs) is not None and pred.load_seconds == loaded  # a bucket loads once
    assert got.shape == (n, 64, 64, 1) and got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1}
    want = serve.make_predict_fn(unet["task"], MEAN, STD)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(pred._fns) == ([1] if n < 4 else [4] if n == 4 else [1, 4])  # buckets load at first use


def test_a_remainder_smaller_than_every_bucket_pads_and_trims(unet, tmp_path):
    p = str(tmp_path / "m4.misx")
    serve.save_predictor(p, serve.export_predictor(unet["task"], 64, MEAN, STD, batch_sizes=(4,)),
                         {"image_size": 64, "platforms": ["cpu"]})
    imgs = _slices(6)
    got = serve.load_predictor(p, device="cpu")(imgs)  # 4, then 2 padded to 4 with the last sample
    np.testing.assert_array_equal(got, serve.load_predictor(unet["art"], device="cpu")(imgs))
    with pytest.raises(ValueError, match="batch bucket must be >= 1, got 0"):
        serve.export_predictor(unet["task"], 64, MEAN, STD, batch_sizes=(0, 2))


def test_artifact_agrees_with_the_jax_artifact(unet, tmp_path):
    p = str(tmp_path / "jax.misx")
    jserve.save_predictor(p, jserve.export_predictor(unet["jt"], unet["state"], image_size=64, mean=MEAN, std=STD,
                                                     batch_sizes=(4,), fp32=True), {"image_size": 64})
    imgs = _slices(4)
    want = jserve.load_predictor(p)(imgs)
    got = serve.load_predictor(unet["art"], device="cpu")(imgs)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert 0.01 < want.mean() < 0.99, "the case must have both classes"
    assert (got == want).mean() >= 0.999
    # each package refuses the other's file and names the right tool
    with pytest.raises(ValueError, match="artifact of the JAX package.*mis-export-torch"):
        serve.load_predictor(p, device="cpu")
    with pytest.raises(ValueError, match="bad magic"):
        jserve.load_predictor(unet["art"])


@pytest.mark.parametrize("hu_windows", [(), WINDOWS], ids=["plain", "hu_windows"])
def test_window_artifact_logits_match_the_jax_window_artifact(unet3d, tmp_path, hu_windows):
    jt, state, task, _ = unet3d[len(hu_windows) or 1]
    p = str(tmp_path / "w.misx")
    serve.save_predictor(p, serve.export_window_predictor(task, (8, 16, 16), MEAN, STD, batch_windows=2,
                                                          hu_windows=hu_windows),
                         {"kind": "window3d", "window": [8, 16, 16], "batch_windows": 2, "platforms": ["cpu"]})
    meta, window_fn = serve.load_window_predictor(p, device="cpu")
    assert meta["window"] == [8, 16, 16] and meta["batch_windows"] == 2
    x = np.random.default_rng(0).random((2, 8, 16, 16, 1)).astype(np.float32)
    got = window_fn(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 8, 16, 16, 1)
    assert torch.equal(got, serve.make_window_fn(task, MEAN, STD, hu_windows)(torch.from_numpy(x)))
    (jexp,) = jserve.export_window_predictor(jt, state, (8, 16, 16), MEAN, STD, batch_windows=2, fp32=True,
                                             hu_windows=hu_windows).values()
    want = np.asarray(jexp.call(jnp.asarray(x)))
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(Exception):  # a captured program takes its one batch size
        window_fn(torch.from_numpy(x[:1]))


def _rewrite(src, dst, edit):
    """Copy a container with its JSON header passed through ``edit``."""
    data = open(src, "rb").read()
    n = len(serve._MAGIC)
    (hlen,) = struct.unpack_from("<I", data, n)
    header = json.dumps(edit(json.loads(data[n + 4:n + 4 + hlen]))).encode()
    with open(dst, "wb") as f:
        f.write(data[:n] + struct.pack("<I", len(header)) + header + data[n + 4 + hlen:])
    return dst


def _with(**meta):
    def edit(header):
        header["meta"].update(meta)
        return header
    return edit


def _two_buckets(header):
    header["meta"]["kind"] = "window3d"
    (entry,) = [header["buckets"]["1"]]
    header["buckets"] = {"1": entry, "2": entry}
    return header


@pytest.mark.parametrize("case,load,match", [
    ("garbage", "load_predictor", "bad magic"),
    ("cut_header", "load_predictor", r"truncated artifact \(header\)"),
    ("cut_bucket", "load_predictor", r"truncated artifact \(bucket 4\)"),
    ("window_kind", "load_predictor", "kind 'window3d' is not a batched 2D predictor.*load_window_predictor"),
    ("batched_kind", "load_window_predictor", "kind 'batched2d' is not a volumetric window predictor"),
    ("two_buckets", "load_window_predictor", r"exactly one bucket \(got \[1, 2\]\)"),
    ("other_device", "load_predictor", r"exported for \['cuda'\], not for 'cpu'.*--device cpu"),
    ("cuda_absent", "load_predictor", "CUDA is not available"),
])
def test_container_refusals(unet, tmp_path, monkeypatch, case, load, match):
    data = open(unet["art"], "rb").read()
    p = str(tmp_path / "x.misx")
    device = "cpu"
    if case == "garbage":
        open(p, "wb").write(b"not an artifact")
    elif case == "cut_header":
        open(p, "wb").write(data[:len(serve._MAGIC) + 10])
    elif case == "cut_bucket":  # a cut file must fail at load, not at the first request
        open(p, "wb").write(data[:len(data) // 2 + len(data) // 4])
    elif case == "window_kind":
        _rewrite(unet["art"], p, _with(kind="window3d"))
    elif case == "batched_kind":
        p = unet["art"]
    elif case == "two_buckets":
        _rewrite(unet["art"], p, _two_buckets)
    elif case == "other_device":
        _rewrite(unet["art"], p, _with(platforms=["cuda"]))
    else:
        _rewrite(unet["art"], p, _with(platforms=["cuda"]))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        device = "cuda"
    with pytest.raises((ValueError, RuntimeError), match=match):
        getattr(serve, load)(p, device=device)


@pytest.mark.parametrize("shape,match", [((1, 32, 32, 1), "exported for 64x64 inputs"),
                                         ((1, 64, 64), r"expected \(N, S, S, 1\) uint8")])
def test_input_validation(unet, shape, match):
    with pytest.raises(ValueError, match=match):
        serve.load_predictor(unet["art"], device="cpu")(np.zeros(shape, np.uint8))


def test_serving_an_artifact_imports_no_model_code(unet):
    code = (
        "import sys, numpy as np\n"
        "from medical_image_segmentation_tpu_torch.serve import load_predictor\n"
        f"masks = load_predictor({unet['art']!r}, device='cpu')(np.zeros((5, 64, 64, 1), np.uint8))\n"
        "assert masks.shape == (5, 64, 64, 1)\n"
        "bad = [m for m in sys.modules if m.startswith(('medical_image_segmentation_tpu_torch.models',"
        " 'medical_image_segmentation_tpu_torch.train', 'jax', 'medical_image_segmentation_tpu.'))]\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


# ------------------------------------------------------------------ the CLIs


def _options(parse_args, argv):
    import argparse

    seen = {}
    original = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        for action in self._actions:
            for opt in action.option_strings:
                seen[opt] = action.default
        return original(self, args, namespace)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        parse_args(argv)
    return seen


@pytest.mark.parametrize("jax_mod,port_mod,argv", [
    (jexport, export, ["--checkpoint", "c", "--output", "o"]),
    (jexport3d, export3d, ["--checkpoint", "c", "--output", "o"]),
    (jpredict, predict, ["--output_dir", "o"]),
], ids=["export", "export3d", "predict"])
def test_every_flag_of_the_jax_twin_with_device_for_platforms(jax_mod, port_mod, argv):
    want, got = _options(jax_mod.parse_args, argv), _options(port_mod.parse_args, argv)
    assert set(got) - set(want) == {"--device"} and set(want) - set(got) <= {"--platforms"}
    same = set(want) - {"--platforms", "--num_workers"}
    assert all(got[k] == want[k] for k in same), {k: (want[k], got[k]) for k in same if got[k] != want[k]}
    assert got["--device"] == "cuda"


def test_export_then_predict_exported_equals_the_checkpoint_run(unet, tmp_path, capfd):
    d = tmp_path
    (d / "slices").mkdir()
    for i, img in enumerate(_slices(5, size=48, seed=9)):  # resized to the artifact's 64² and back
        write_png(str(d / "slices" / f"s{i}.png"), img[..., 0])
    art = str(d / "model.misx")
    stats = ["--mean", str(MEAN), "--std", str(STD)]
    capfd.readouterr()
    assert export.main(["--checkpoint", unet["ckpt"], "--output", art, "--image_size", "64", *stats,
                        "--batch_sizes", "1,2", "--fp32", "--device", "cpu"]) == 0
    summary = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert summary == {"artifact": art, "bytes": os.path.getsize(art), "batch_sizes": [1, 2], "platforms": ["cpu"],
                       "checkpoint_step": 3}
    meta = serve.load_predictor(art, device="cpu").meta
    assert set(meta) == {"kind", "arch", "image_size", "mean", "std", "threshold", "hu_windows", "batch_sizes",
                         "platforms", "checkpoint_step", "torch_version", "dtype"}
    assert meta["kind"] == "batched2d" and meta["dtype"] == "float32" and meta["torch_version"] == torch.__version__
    serve_argv = ["--images_dir", str(d / "slices"), "--num_workers", "1", "--device", "cpu"]
    predict.main(["--checkpoint", unet["ckpt"], "--image_size", "64", *stats, "--fp32", "--batch_size", "2",
                  "--output_dir", str(d / "ckpt_masks"), *serve_argv])
    capfd.readouterr()
    assert predict.main(["--exported", art, "--output_dir", str(d / "art_masks"), *serve_argv]) == 0
    served = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert served["exported"] is True and served["images"] == 5 and served["mode"] == "batched"
    assert 0.0 < served["load_seconds"] < served["seconds"]  # the buckets' lazy load lies inside the clock
    names = sorted(os.listdir(d / "ckpt_masks"))
    assert names == sorted(os.listdir(d / "art_masks")) == [f"s{i}_mask.png" for i in range(5)]
    for n in names:
        assert (d / "art_masks" / n).read_bytes() == (d / "ckpt_masks" / n).read_bytes(), n
    with pytest.raises(ValueError, match="not a batched 2D predictor"):
        predict.main(["--exported", _rewrite(art, str(d / "w.misx"), _with(kind="window3d")),
                      "--output_dir", str(d / "x"), *serve_argv])


@pytest.mark.parametrize("flags", [["--threshold", "0.7"], ["--hu_windows", "96:160"], ["--mean", "0.1"],
                                   ["--std", "0.3"], ["--dataset", "DECATHLON_LIVER"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_exported_refuses_what_is_baked_into_the_artifact(flags):
    with pytest.raises(SystemExit, match=f"{flags[0]}: baked into the artifact.*mis-export-torch"):
        predict.main(["--exported", "m.misx", *flags, "--images_dir", "x", "--output_dir", "y", "--device", "cpu"])


def test_exported_excludes_sliding_window_and_checkpoint():
    with pytest.raises(SystemExit, match="exactly one of --checkpoint"):
        predict.main(["--images_dir", "x", "--output_dir", "y"])
    with pytest.raises(SystemExit, match="--sliding_window needs --checkpoint"):
        predict.main(["--exported", "m.misx", "--sliding_window", "96", "--images_dir", "x", "--output_dir", "y"])


@pytest.mark.parametrize("in_ch", [1, 2], ids=["plain", "hu_windows"])
def test_export3d_then_predict3d_exported_equals_the_checkpoint_run(unet3d, tmp_path, capfd, in_ch):
    ckpt = unet3d[in_ch][3]
    vols = tmp_path / "vols"
    vols.mkdir()
    rng = np.random.default_rng(2)
    write_nifti(str(vols / "big.nii.gz"), rng.random((20, 18, 10)).astype(np.float32))   # 2·2·2 ragged windows
    # one window exactly. (A volume SMALLER than the window is zero-padded before the artifact normalizes
    # it and after the checkpoint path has, in both packages, so only there the two routes may differ.)
    write_nifti(str(vols / "small.nii.gz"), rng.random((16, 16, 8)).astype(np.float32))
    hu = ["--hu_windows", ",".join(f"{lv}:{wd}" for lv, wd in WINDOWS)] if in_ch == 2 else []
    model = ["--features", "4", "8", "--window", "8", "16", "16", "--batch_windows", "3", "--fp32", "--device", "cpu",
             "--mean", "0.45", "--std", "0.3", *hu]
    art = str(tmp_path / "w3d.misx")
    capfd.readouterr()
    assert export3d.main(["--checkpoint", ckpt, "--output", art, *model]) == 0
    summary = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert summary == {"artifact": art, "bytes": os.path.getsize(art), "window": [8, 16, 16], "batch_windows": 3,
                       "platforms": ["cpu"], "checkpoint_step": 2}
    meta, _ = serve.load_window_predictor(art, device="cpu")
    assert set(meta) == {"kind", "window", "batch_windows", "features", "norm", "mean", "std", "hu_windows",
                         "platforms", "checkpoint_step", "torch_version", "dtype"}
    assert meta["hu_windows"] == [list(w) for w in WINDOWS[:in_ch * (in_ch - 1)]]
    predict3d.main(["--checkpoint", ckpt, "--images_dir", str(vols), "--output_dir", str(tmp_path / "ckpt_masks"),
                    *model])
    capfd.readouterr()
    # window, batch, windows and normalization come from the artifact; other values given here are overridden
    assert predict3d.main(["--exported", art, "--images_dir", str(vols), "--output_dir", str(tmp_path / "art_masks"),
                           "--window", "16", "16", "16", "--device", "cpu"]) == 0
    served = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert served["exported"] is True and served["volumes"] == 2 and served["window"] == [8, 16, 16]
    assert served["windows"] == 8 + 1 and served["fused_shapes"] == 2
    both = []
    for n in ("big_mask.nii.gz", "small_mask.nii.gz"):
        a = np.asarray(read_nifti(str(tmp_path / "art_masks" / n)).data)
        np.testing.assert_array_equal(a, np.asarray(read_nifti(str(tmp_path / "ckpt_masks" / n)).data))
        both.append(a.mean())
    assert 0.0 < np.mean(both) < 1.0, "the case must have both classes"
    with pytest.raises(ValueError, match="not a volumetric window predictor"):
        predict3d.main(["--exported", _rewrite(art, str(tmp_path / "b.misx"), _with(kind="batched2d")),
                        "--images_dir", str(vols), "--output_dir", str(tmp_path / "x"), "--device", "cpu"])
