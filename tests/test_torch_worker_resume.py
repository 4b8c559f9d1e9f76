"""The port's worker resumes bit for bit (CPU, port only).

Mirrors the JAX package's ``tests/test_engine.py::
test_resume_is_equivalent_to_uninterrupted`` and ``tests/
test_midepoch_resume.py``: an epoch resume equal to the uninterrupted
run (Adam; SGD with ``opt.ema`` and ``opt.accumulate_steps``), the
``max_steps`` stop inside an epoch and its bitwise resume, a stop at the
epoch boundary, and ``checkpoint_every_steps``.  The runs and helpers
are those of ``tests/test_torch_worker_host.py``.
"""

import pytest
import torch

from openset_imagenet_tpu_torch import checkpoint as ckpt
from tests.test_torch_worker_host import (  # noqa: F401 (autouse fixture)
    assert_files_equal, curr_of, one_torch_thread, run, tiny_cfg,
    write_protocol_csvs)


@pytest.mark.parametrize("opt", [
    {"type": "adam", "lr": 1e-3},
    {"type": "sgd", "lr": 1e-2, "ema": 0.9, "accumulate_steps": 2}])
def test_resume_is_equivalent_to_uninterrupted(tmp_path, opt):
    """1 epoch + resume(1 epoch) == 2 straight epochs, bit for bit, with
    the optimizer, and the EMA shadow and a half-full accumulation (five
    batches an epoch, two micro-steps an update) where they are on."""
    write_protocol_csvs(tmp_path)
    loss = "garbage" if "ema" in opt else "entropic"
    straight = tiny_cfg(tmp_path, loss, epochs=2, out="straight", opt=opt)
    run(straight)
    run(tiny_cfg(tmp_path, loss, epochs=1, out="resumed", opt=opt))
    resumed = tiny_cfg(tmp_path, loss, epochs=2, out="resumed", opt=opt)
    resumed.checkpoint = str(curr_of(resumed))
    if "ema" in opt:
        payload = torch.load(resumed.checkpoint, weights_only=True)
        assert payload["accumulation"]["mini_step"] == 1
        assert payload["step"] == 5 and payload["updates"] == 2
    run(resumed)
    assert_files_equal(curr_of(straight), curr_of(resumed))


def test_max_steps_stops_midepoch_and_resume_is_bitwise(tmp_path):
    write_protocol_csvs(tmp_path)
    straight = tiny_cfg(tmp_path, epochs=2, out="straight")
    run(straight)
    # 5 batches an epoch; 7 steps = epoch 0 and two steps of epoch 1.
    cut = tiny_cfg(tmp_path, epochs=2, out="resumed", max_steps=7)
    info = run(cut)
    assert info["stopped_mid_epoch"] == 2 and info["last_epoch"] == 1
    meta = ckpt.read_metadata(curr_of(cut))
    assert meta["extra"]["progress"] == {"epoch": 1, "next_batch": 2}
    assert meta["epoch"] == 1  # completed epochs, not the one cut
    resumed = tiny_cfg(tmp_path, epochs=2, out="resumed",
                       checkpoint=str(curr_of(cut)))
    assert run(resumed)["stopped_mid_epoch"] is None
    meta = ckpt.read_metadata(curr_of(resumed))
    assert meta["epoch"] == 2 and "progress" not in meta["extra"]
    assert_files_equal(curr_of(straight), curr_of(resumed))


def test_max_steps_at_epoch_boundary(tmp_path):
    write_protocol_csvs(tmp_path)
    cfg = tiny_cfg(tmp_path, epochs=3, max_steps=5)  # = one epoch
    info = run(cfg)
    assert info["stopped_mid_epoch"] is None and info["last_epoch"] == 0
    meta = ckpt.read_metadata(curr_of(cfg))
    assert meta["epoch"] == 1 and "progress" not in meta["extra"]


def test_checkpoint_every_steps_writes_progress(tmp_path):
    write_protocol_csvs(tmp_path)
    cfg = tiny_cfg(tmp_path, epochs=1, max_steps=4, checkpoint_every_steps=2)
    run(cfg)
    meta = ckpt.read_metadata(curr_of(cfg))
    assert meta["extra"]["progress"] == {"epoch": 0, "next_batch": 4}

