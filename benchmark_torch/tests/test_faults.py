"""Each fault a cell can have, planted under the timed path, turns
``correct`` false: a step that returns its state unchanged, half of the
batch left out (the mean taken over the rest), and an answer altered
where it is produced.  The cells run on one card, so there is no exchange
between cards to leave out.  The runs skip the look for a card and go
through the same generator and check as ``run.py``, on the CPU at a tiny
size, against the limits of ``configs/resnet50-p1.json``.  The model is
built in float32 there, so that a sound run sits at round-off and what
turns ``correct`` false is the fault alone."""

import numpy as np
import pytest
import torch

from conftest import traffic

from benchmark_torch.lib import (compare, drive_predict, drive_serve,
                                 drive_train, harness)


@pytest.fixture(autouse=True)
def float32_program(monkeypatch):
    from openset_imagenet_tpu_torch import inference
    from openset_imagenet_tpu_torch import train as engine

    build = engine.build_model

    def build32(*a, **k):
        return build(*a, dtype=torch.float32, **k)

    monkeypatch.setattr(engine, "build_model", build32)
    monkeypatch.setattr(inference, "build_model", build32)


def _correct(ctx, res) -> bool:
    return compare.judge(res.numbers, harness.limits_of(ctx))[0]


def _train(make_ctx, seed=5):
    return make_ctx(traffic("train_b256", warm_steps=4,
                            max_imgs_per_s=100000), seed=seed, seconds=0.2)


def test_train_state_unchanged(make_ctx, monkeypatch):
    from openset_imagenet_tpu_torch import train as engine

    monkeypatch.setattr(engine.TrainState, "apply_gradients",
                        lambda self: setattr(self, "step", self.step + 1))
    ctx = _train(make_ctx)
    res = drive_train.run(ctx)
    assert res.numbers["change_gap"] == pytest.approx(1.0)
    assert not _correct(ctx, res)


def test_train_half_batch(make_ctx, monkeypatch):
    from openset_imagenet_tpu_torch import train as engine

    make = engine.make_loss_fn

    def half(*a, **k):
        loss_fn = make(*a, **k)

        def cut(logits, labels, mask=None):
            h = logits.shape[0] // 2
            return loss_fn(logits[:h], labels[:h],
                           None if mask is None else mask[:h])
        return cut

    monkeypatch.setattr(engine, "make_loss_fn", half)
    ctx = _train(make_ctx)
    res = drive_train.run(ctx)
    assert not _correct(ctx, res)


def _altered(monkeypatch, how):
    from openset_imagenet_tpu_torch.inference import OpenSetPredictor

    finish = OpenSetPredictor._finish

    def patched(self, n, outputs, *a, **k):
        pred, score, *rest = finish(self, n, outputs, *a, **k)
        if how == "answer":
            pred = (pred + 1) % self.n_classes
        else:
            pred, score = pred[:len(pred) // 2], score[:len(score) // 2]
            rest = [r[:len(r) // 2] for r in rest]
        return (pred, score, *rest)

    monkeypatch.setattr(OpenSetPredictor, "_finish", patched)


@pytest.mark.parametrize("how", ["answer", "half"])
def test_predict_faults(make_ctx, monkeypatch, how):
    _altered(monkeypatch, how)
    ctx = make_ctx(traffic("predict_b256", batch=16, distinct_images=64,
                           check_rows=32, calibration_images=8,
                           max_imgs_per_s=100000))
    res = drive_predict.run(ctx)
    assert not _correct(ctx, res)
    if how == "half":
        assert res.numbers["missing"] > 0


def test_serve_answer_altered(make_ctx, monkeypatch):
    _altered(monkeypatch, "answer")
    ctx = make_ctx(traffic("serve_open", rate=40.0, max_batch=8,
                           connections=8, distinct_images=64, check_rows=16,
                           calibration_images=8), seconds=1.0)
    res = drive_serve.run(ctx)
    assert not _correct(ctx, res)


def test_sound_runs_are_correct(make_ctx):
    """Without a fault, the same tiny runs are correct, so the faults
    above are what the check sees."""
    ctx = make_ctx(traffic("predict_b256", batch=16, distinct_images=64,
                           check_rows=32, calibration_images=8,
                           max_imgs_per_s=100000))
    res = drive_predict.run(ctx)
    assert _correct(ctx, res), res.numbers
    assert np.isfinite(list(res.numbers.values())).all()
