"""The port's worker stops cleanly (CPU, port only).

Mirrors the JAX package's ``tests/test_midepoch_resume.py``: SIGTERM in
``preempt_mode: step`` and the bitwise resume after it, a resume that
rejects a changed batch geometry (and closes the pipelines), a spent
budget that trains nothing; and early stopping on γ and the profiler
trace.  The runs and helpers are those of
``tests/test_torch_worker_host.py``.
"""

import csv
import os
import signal
import threading
import time
from pathlib import Path

import pytest

from openset_imagenet_tpu_torch import checkpoint as ckpt
from openset_imagenet_tpu_torch import train as engine
from tests.test_torch_worker_host import (  # noqa: F401 (autouse fixture)
    assert_files_equal, curr_of, one_torch_thread, run, tiny_cfg,
    write_protocol_csvs)


def test_sigterm_step_mode_saves_resumable_checkpoint(tmp_path,
                                                      monkeypatch):
    """preempt_mode: step stops at the next step after SIGTERM with a
    resumable _curr, and the resume completes the run bit for bit.

    The second train step waits until the signal was sent, so it lands
    mid-epoch, while the worker's handler is installed."""
    write_protocol_csvs(tmp_path)
    straight = tiny_cfg(tmp_path, epochs=2, out="straight")
    run(straight)
    cfg = tiny_cfg(tmp_path, epochs=2, out="cut", preempt_mode="step",
                   preempt_check_steps=1, checkpoint_every_steps=1)
    curr = curr_of(cfg)
    fired = threading.Event()
    real = engine.make_train_step
    calls = []

    def gated(loss_fn, **kwargs):
        inner = real(loss_fn, **kwargs)

        def step(*args):
            calls.append(1)
            if len(calls) == 2:
                assert fired.wait(timeout=60)
            return inner(*args)
        return step

    def fire_when_started():
        for _ in range(6000):
            if curr.exists():  # the first step's mid-epoch save
                os.kill(os.getpid(), signal.SIGTERM)
                fired.set()
                return
            time.sleep(0.005)

    monkeypatch.setattr(engine, "make_train_step", gated)
    t = threading.Thread(target=fire_when_started, daemon=True)
    t.start()
    info = run(cfg)
    t.join(timeout=60)
    assert fired.is_set() and not t.is_alive()
    assert (info["last_epoch"], info["stopped_mid_epoch"]) == (0, 2)
    meta = ckpt.read_metadata(curr)
    assert meta["extra"]["progress"] == {"epoch": 0, "next_batch": 2}
    monkeypatch.setattr(engine, "make_train_step", real)
    resumed = tiny_cfg(tmp_path, epochs=2, out="cut", checkpoint=str(curr))
    assert run(resumed)["stopped_mid_epoch"] is None
    assert ckpt.read_metadata(curr)["epoch"] == 2
    assert_files_equal(curr_of(straight), curr)


def test_resume_rejects_changed_batch_geometry(tmp_path, monkeypatch):
    """A progress checkpoint holds only for its batch geometry, and the
    rejection closes the pipelines already built."""
    write_protocol_csvs(tmp_path)
    cfg = tiny_cfg(tmp_path, epochs=2, max_steps=7)
    run(cfg)
    built = []
    real = engine.pipeline_from_dataset

    def spy(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(engine, "pipeline_from_dataset", spy)
    with pytest.raises(ValueError, match="batches/epoch"):
        run(tiny_cfg(tmp_path, epochs=2, batch_size=37,
                     checkpoint=str(curr_of(cfg))))
    assert len(built) == 2 and all(p._pool._shutdown for p in built)


def test_resume_with_exhausted_budget_trains_nothing(tmp_path):
    write_protocol_csvs(tmp_path)
    cfg = tiny_cfg(tmp_path, epochs=2, max_steps=7)
    info = run(cfg)
    before = curr_of(cfg).read_bytes()
    again = run(tiny_cfg(tmp_path, epochs=2, max_steps=7,
                         checkpoint=str(curr_of(cfg))))
    assert again["stopped_mid_epoch"] == info["stopped_mid_epoch"] == 2
    assert again["last_epoch"] == info["last_epoch"]
    assert curr_of(cfg).read_bytes() == before


def test_worker_early_stopping_on_gamma(tmp_path):
    """patience: 1 ends the run at the first epoch whose γ is no better
    than the best before it."""
    write_protocol_csvs(tmp_path)
    cfg = tiny_cfg(tmp_path, epochs=6, patience=1,
                   opt={"type": "sgd", "lr": 0.5})
    info = run(cfg)
    with open(Path(cfg.output_directory) / "scalars-training.log.csv") as f:
        rows = list(csv.DictReader(f))  # the record's exact values
    kn, unk = ([float(r["value"]) for r in rows if r["tag"] == tag]
               for tag in ("val/conf_kn", "val/conf_unk"))
    gamma = [a + b for a, b in zip(kn, unk)]
    expect = next((e for e in range(1, len(gamma))
                   if gamma[e] < max(gamma[:e])), 5)
    assert info["last_epoch"] == expect and len(gamma) == expect + 1


def test_profile_writes_a_trace(tmp_path):
    write_protocol_csvs(tmp_path)
    cfg = tiny_cfg(tmp_path, epochs=1, profile={
        "dir": str(tmp_path / "prof"), "epochs": [0]})
    run(cfg)
    assert (tmp_path / "prof" / "entropic_epoch0.trace.json").stat().st_size

