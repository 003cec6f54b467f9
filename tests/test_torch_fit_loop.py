"""``train/loop.py``, the loop the four trainers share, on a stub task.

The trainers' own tests hold whole runs against the JAX package
(``test_torch_resume.py``, ``test_torch_train3d.py``,
``test_torch_train_segmentation.py``, ``test_torch_train_flags.py``,
``test_torch_multiprocess_cli.py``). These pin the loop's bookkeeping
alone: which batches a resumed epoch trains, which epoch a stop
checkpoints, the periodic cadence and the profiler's trace when a step
raises.
"""

import argparse
import os
import signal

import pytest
import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint
from medical_image_segmentation_tpu_torch.train.loop import FitRun, TrainLoop, batch_range, epoch_steps, start_ranks
from medical_image_segmentation_tpu_torch.train.resilience import PreemptionGuard

STEPS = 4  # steps an epoch trains, of the 6 batches the stub loader holds
LOADER_BATCHES = 6


class StubTask:
    """A task whose state is its step count."""

    def __init__(self):
        self.step = 0

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, state):
        self.step = int(state["step"])


class StubLoader:
    epoch = 0


def _args(tmp_path, **kw):
    base = dict(seed=0, resume=False, checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"),
                skip_hbm_check=True, force_hbm=False, max_epochs=3, checkpoint_every_epochs=0, batch_size=2,
                limit_steps_per_epoch=STEPS)
    return argparse.Namespace(**{**base, **kw})


def _fit(args, on_step=None, checkpoint_last=False, profile=0):
    """One run of the loop; returns its record, the ``(epoch, batch)`` it
    trained and the ``(start, stop)`` each epoch asked its batches for."""
    proc, mesh = start_ranks("cpu", args.batch_size)
    task, loader = StubTask(), StubLoader()
    out = FitRun(task=task)
    loop = TrainLoop(args, proc, mesh, task, loader, epoch_steps(args, LOADER_BATCHES, 2, "the stub set"), out)
    trained, asked, epoch = [], [], [loop.start_epoch]

    def batches(start, stop):
        asked.append((start, stop))
        return batch_range(((torch.tensor(k),) for k in range(LOADER_BATCHES)), start, stop)

    def step(k):
        task.step += 1
        trained.append((epoch[0], int(k)))
        if on_step is not None:
            on_step(task.step)
        return {"loss": k.float()}

    def end_epoch(e, metrics, record):
        assert record == out.epochs[-1] and record["steps"] == len([t for t in trained if t[0] == e])
        epoch[0] = e + 1

    loop.run(batches, step, end_epoch, rate="img_per_s", loss="loss", checkpoint_last=checkpoint_last,
             profile=profile)
    return out, trained, asked


def _signal_after(stop_step):
    def on_step(step):
        if step == stop_step:
            os.kill(os.getpid(), signal.SIGTERM)
    return on_step


@pytest.fixture
def guard_calls(monkeypatch):
    """Every ``stop_agreed`` the loop asks: ``(step_idx, at_epoch_end)``."""
    calls, original = [], PreemptionGuard.stop_agreed

    def recorded(self, step_idx=-1, at_epoch_end=False):
        calls.append((step_idx, at_epoch_end))
        return original(self, step_idx, at_epoch_end)

    monkeypatch.setattr(PreemptionGuard, "stop_agreed", recorded)
    return calls


@pytest.mark.parametrize("stop_step", [1, 3, 4, 6, 11])
def test_a_stop_checkpoints_its_epoch_and_the_resume_skips_exactly_its_batches(tmp_path, guard_calls, stop_step):
    """A signal after global step ``stop_step``: the checkpoint's epoch is
    the one whose batch the next step reads (``epoch``, or ``epoch + 1``
    after an epoch's last step), and the resumed run trains the batches
    from there to the end, each once: the two runs together are the
    uninterrupted one. The guard's index counts from the epoch's start."""
    whole = [(e, k) for e in range(3) for k in range(STEPS)]
    before = signal.getsignal(signal.SIGTERM)
    first, trained, _ = _fit(_args(tmp_path), _signal_after(stop_step))
    assert first.stopped and trained == whole[:stop_step] and signal.getsignal(signal.SIGTERM) is before
    assert first.checkpoint == str(tmp_path / "ckpt" / f"{stop_step}.pt")
    assert load_checkpoint(first.checkpoint)["epoch"] == stop_step // STEPS
    assert [i for i, at_end in guard_calls if not at_end] == [k for _, k in whole[:stop_step]]

    guard_calls.clear()
    second, rest, asked = _fit(_args(tmp_path, resume=True))
    skipped = stop_step % STEPS
    assert (second.resumed_from, second.skipped, second.stopped) == (stop_step, skipped, False)
    assert rest == whole[stop_step:] and trained + rest == whole
    assert asked[0] == (skipped, STEPS) and all(a == (0, STEPS) for a in asked[1:])
    assert [i for i, at_end in guard_calls if not at_end] == [k for _, k in whole[stop_step:]]
    assert [e["steps"] for e in second.epochs] == [STEPS - skipped] + [STEPS] * (len(asked) - 1)


def test_a_stop_at_an_epochs_end_checkpoints_the_next_epoch(tmp_path, monkeypatch):
    ends = []

    def agreed(self, step_idx=-1, at_epoch_end=False):
        ends.extend([1] if at_epoch_end else [])
        return at_epoch_end and len(ends) == 2

    monkeypatch.setattr(PreemptionGuard, "stop_agreed", agreed)
    out, trained, _ = _fit(_args(tmp_path))
    assert out.stopped and len(trained) == 2 * STEPS and len(out.epochs) == 1  # epoch 1 stopped before its record
    assert load_checkpoint(out.checkpoint)["epoch"] == 2 and out.checkpoint.endswith(f"{2 * STEPS}.pt")


@pytest.mark.parametrize("every,last,epochs", [
    (1, True, [1, 2, 3]), (1, False, [1, 2]), (2, True, [2]), (2, False, [2]), (0, True, []),
])
def test_the_periodic_checkpoint_with_and_without_the_last_epoch(tmp_path, every, last, epochs):
    out, trained, _ = _fit(_args(tmp_path, checkpoint_every_epochs=every), checkpoint_last=last)
    assert not out.stopped and len(trained) == 3 * STEPS
    ckpt = tmp_path / "ckpt"
    steps = sorted(int(f[:-3]) for f in os.listdir(ckpt)) if ckpt.exists() else []
    assert steps == [e * STEPS for e in epochs]
    assert [load_checkpoint(str(ckpt / f"{s}.pt"))["epoch"] for s in steps] == epochs
    assert out.checkpoint == (str(ckpt / f"{steps[-1]}.pt") if steps else "")
    assert [(e["steps"], set(e)) for e in out.epochs] == [(STEPS, {"steps", "seconds", "img_per_s", "loss"})] * 3


def test_the_profiler_is_stopped_and_its_trace_recorded_when_a_step_raises(tmp_path):
    def fail(step):
        if step == 2:
            raise RuntimeError("step 2 failed")

    before = signal.getsignal(signal.SIGTERM)
    args = _args(tmp_path)
    proc, mesh = start_ranks("cpu", args.batch_size)
    out = FitRun(task=StubTask())
    loop = TrainLoop(args, proc, mesh, out.task, StubLoader(), STEPS, out)

    def step(k):
        out.task.step += 1
        fail(out.task.step)
        return {"loss": k.float()}

    with pytest.raises(RuntimeError, match="step 2 failed"):
        loop.run(lambda start, stop: batch_range(((torch.tensor(0.0),) for _ in range(STEPS)), start, stop), step,
                 lambda *a: None, rate="img_per_s", loss="loss", checkpoint_last=True, profile=5)
    assert out.trace == str(tmp_path / "logs" / "trace" / "trace.json") and os.path.exists(out.trace)
    assert not out.stopped and out.epochs == [] and signal.getsignal(signal.SIGTERM) is before


def test_epoch_steps_caps_and_refuses_an_empty_epoch(tmp_path):
    assert epoch_steps(_args(tmp_path), 6, 2, "x") == STEPS
    assert epoch_steps(_args(tmp_path, limit_steps_per_epoch=0), 6, 2, "x") == 6
    with pytest.raises(SystemExit, match=r"--batch_size 2 \(per rank 2\) exceeds the stub set: every epoch would "
                                         r"run 0 steps"):
        epoch_steps(_args(tmp_path), 0, 2, "the stub set")


def test_batch_range_closes_the_epochs_iterator():
    closed = []

    def epoch():
        try:
            yield from range(6)
        finally:
            closed.append(True)

    assert list(batch_range(epoch(), 2, 4)) == [2, 3] and closed == [True]
    it = batch_range(epoch(), 1, 5)
    assert next(it) == 1 and len(closed) == 1
    it.close()  # a run that stops mid-epoch
    assert closed == [True, True]
