"""The port's schedules, optimizers and train-state checkpoints (CPU).

* ``build_lr_schedule``: StepLR, cosine and warmup forms at every update
  count 0 .. 3 * steps_per_epoch, against the JAX package's schedules
  within 1e-7 (lr 0.1; the JAX schedule computes in float32).
* ``build_optimizer``: Adam and SGD(momentum) updates on synthetic
  gradients, with a warmup that changes the rate every update: the
  parameters after four updates against optax's within rtol 1e-6 (atol
  1e-6 for parameters near 0).  The updates themselves differ by up to
  7e-6 relative for Adam, because optax computes the bias corrections
  ``1 - b**t`` in float32 (``1 - 0.999f`` is 1.3e-5 off 1e-3) and torch
  in float64; that moves a parameter of order 1 by at most one ulp.
* Checkpoints: a ``.pth`` with optimizer state and step; resuming after
  one step and taking a second equals two straight steps, bitwise, in
  float32 on the CPU; ``epoch + 1`` is stored.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openset_imagenet_tpu import train as jengine
from openset_imagenet_tpu.config import NameSpace as JaxNameSpace
from openset_imagenet_tpu_torch import train as pengine
from openset_imagenet_tpu_torch.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
from openset_imagenet_tpu_torch.config import NameSpace

SCHEDULES = {
    "constant": {"lr": 0.1},
    "step": {"lr": 0.1, "decay": 1, "gamma": 0.5},
    "step_decay2": {"lr": 0.1, "decay": 2, "gamma": 0.3},
    "cosine": {"lr": 0.1, "schedule": "cosine", "min_lr_ratio": 0.1},
    "warmup_step": {"lr": 0.1, "decay": 1, "gamma": 0.5,
                    "warmup_epochs": 1},
    "warmup_cosine": {"lr": 0.1, "schedule": "cosine", "warmup_epochs": 1},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match_jax(name):
    spe, epochs = 4, 3
    cfg = SCHEDULES[name]
    ours = pengine.build_lr_schedule(NameSpace(cfg), spe, epochs=epochs)
    ref = jengine.build_lr_schedule(JaxNameSpace(cfg), spe, epochs=epochs)
    counts = np.arange(0, 3 * spe + 1)
    got = np.array([ours(int(c)) for c in counts])
    want = np.array([float(ref(jnp.int32(c))) for c in counts])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert len(set(np.round(want, 6))) > 1 or name == "constant"


def _updates(kind, steps=4, seed=0):
    """(port params, optax params) after ``steps`` updates on the same
    synthetic gradients."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(steps)]
    cfg = {"type": kind, "lr": 1e-2, "warmup_epochs": 1, "decay": 1,
           "gamma": 0.5}

    tx = jengine.build_optimizer(JaxNameSpace(cfg), steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    ptx = pengine.build_optimizer(NameSpace(cfg), steps_per_epoch=2)
    state = pengine.TrainState(None, ptx.make(list(tp.values())),
                               ptx.schedule)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        state.apply_gradients()
    assert state.step == steps
    return ({k: v.detach().numpy() for k, v in tp.items()},
            {k: np.asarray(v) for k, v in jp.items()}, params)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizer_updates_match_optax(kind):
    got, ref, start = _updates(kind)
    for k in ref:
        assert np.abs(ref[k] - start[k]).min() > 1e-4, k  # params moved
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_deferred_optimizer_options_raise():
    # opt.ema and opt.accumulate_steps are ported (tests/test_torch_worker.py
    # holds them against optax); ZeRO-1 waits for the multi-GPU slice.
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        pengine.build_optimizer(NameSpace({"lr": 1e-3, "zero1": True}), 1)
    with pytest.raises(ValueError, match="opt.ema"):
        pengine.build_optimizer(NameSpace({"lr": 1e-3, "ema": 1.5}), 1)
    tx = pengine.build_optimizer(NameSpace({"lr": 1e-3, "ema": 0.99,
                                            "accumulate_steps": 2}), 1)
    assert (tx.accumulate_steps, tx.ema) == (2, 0.99)


def _tiny_state(kind="adam"):
    cfg = NameSpace({"model": {"variant": "tiny50", "bn_stats_rows": 4}})
    model = pengine.build_model(cfg, 5, dtype=torch.float32, device="cpu")
    tx = pengine.build_optimizer(NameSpace({"type": kind, "lr": 1e-2,
                                            "warmup_epochs": 1}), 2)
    return pengine.create_state(model, tx)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (8, 32, 32, 3), np.uint8),
            rng.integers(-1, 5, 8).astype(np.int32), np.ones(8, np.float32))


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_resume_is_bitwise(tmp_path, kind):
    step = pengine.make_train_step(pengine.make_loss_fn("entropic",
                                                        fused="auto"))
    straight = _tiny_state(kind)
    for seed in (1, 2):
        step(straight, *_batch(seed))

    first = _tiny_state(kind)
    step(first, *_batch(1))
    path = tmp_path / "entropic_curr.pth"
    save_checkpoint(path, first, epoch=4, best_score=0.25)
    resumed = _tiny_state(kind)
    _, epoch, best = load_checkpoint(path, resumed)
    assert (epoch, best, resumed.step, resumed.updates) == (5, 0.25, 1, 1)
    step(resumed, *_batch(2))

    assert resumed.step == straight.step == 2
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for name, value in st.items():
            assert torch.equal(value, sb["state"][i][name]), (i, name)


def test_weights_only_checkpoint_refuses_an_optimizer(tmp_path):
    state = _tiny_state()
    path = tmp_path / "weights.pth"
    save_checkpoint(path, state.model, epoch=0, best_score=0.0)
    assert load_checkpoint(path, state.model)[1:] == (1, 0.0)
    assert torch.load(path, weights_only=True)["step"] == 0
    with pytest.raises(ValueError, match="no optimizer state"):
        load_checkpoint(path, state)
