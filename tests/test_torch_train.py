"""The port's train step against the JAX package's (CPU, tiny50, float32).

Shared weights (``convert.py``), the same numpy batches, JAX's losses
through its Pallas kernels in interpreter mode and the port's through its
autograd Functions (the K1-K4 plain versions on CPU tensors).  The
entropic runs use ghost batch-norm over 4 of 8 rows (the ``SubsetBatch
Norm`` form), softmax and garbage full-batch statistics (flax form).
Images are 48 px: at 32 px the last stage is 1x1, and a ghost window of 4
values per channel makes the fast variance so ill-conditioned that JAX's
float32 logits move 1e-4 from a float64 forward.

* Three steps, each loss, SGD and Adam.  Each port step starts from
  JAX's state before that step, carried across by ``convert`` (parameters,
  statistics, the optax state, the step count), and is held to JAX's
  state after it: loss within rtol 1e-4, batch statistics within rtol and
  atol 1e-5, parameters within atol 1e-5 (float32 sums in another order),
  Adam's moments within rtol 1e-4 of the value plus 1e-4 of the tensor's
  largest value, and Adam's first gradients (JAX's through ``mu_1 = 0.1 *
  g``) the same.  Starting each step from JAX's state keeps a ReLU that
  the two float32 runs put on opposite sides of zero from compounding
  over the steps (such a kink moves float32 and float64 runs of the same
  code apart by 1e-4 within three SGD steps at lr 1e-2).  Adam's
  parameters are not compared: its update ``lr * mu_hat / sqrt(nu_hat)``
  is of order ``lr`` where the gradient is rounding noise, so the two
  runs step apart there by up to ``2 * lr``.  The ghost-window (entropic)
  runs take ten times these parameter, statistic and moment tolerances:
  over three SGD steps JAX's float32 ``SubsetBatchNorm`` path lands 6.8e-5
  from a float64 run of the port, and the port's float32 run 3.5e-6
  (measured on these inputs), so the gap is JAX's rounding.
* Masked ragged tail: the tail step on a batch padded to 8 rows (3 valid,
  padding last) equals the port's step on the 3 unpadded rows and JAX's
  tail step, for a model with full-batch statistics and one with a ghost
  window wider than the tail.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_imagenet_tpu import train as jengine
from openset_imagenet_tpu.config import NameSpace as JaxNameSpace
from openset_imagenet_tpu.models.resnet import build_resnet as jax_build
from openset_imagenet_tpu_torch import convert
from openset_imagenet_tpu_torch import train as pengine
from openset_imagenet_tpu_torch.config import NameSpace
from tests.test_torch_model import _random_variables

SIZE, BATCH, STEPS = 32, 8, 3
LR = {"sgd": 1e-2, "adam": 1e-3}
GHOST = {"entropic": 6, "softmax": 0, "garbage": 0}


def _n_classes(loss):
    return 9 if loss == "garbage" else 8


def _weights(loss):
    if loss != "garbage":
        return None
    return np.random.default_rng(1).uniform(0.5, 2.0, 9).astype(np.float32)


def _batches(loss, seed=0):
    rng = np.random.default_rng(seed)
    low = 0 if loss == "garbage" else -1
    return [(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8),
             rng.integers(low, _n_classes(loss), BATCH).astype(np.int32),
             np.ones(BATCH, np.float32)) for _ in range(STEPS)]


def _jax_state(loss, kind, ghost):
    n = _n_classes(loss)
    model = jax_build("tiny50", fc_layer_dim=n, out_features=n,
                      dtype=jnp.float32, bn_stats_rows=ghost)
    tx = jengine.build_optimizer(JaxNameSpace({"type": kind,
                                               "lr": LR[kind]}), 1)
    variables = _random_variables(model, seed=17)
    state = jengine.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), apply_fn=model.apply, tx=tx)
    return model, state, variables


def _snapshot(state, metrics):
    return {"loss_sum": float(metrics["loss_sum"]),
            "count": float(metrics["count"]),
            **jax.device_get({"params": state.params,
                              "batch_stats": state.batch_stats,
                              "opt_state": state.opt_state})}


@functools.lru_cache(maxsize=None)
def _jax_run(loss, kind):
    """JAX's trajectory: the initial variables and a snapshot per step."""
    _, state, variables = _jax_state(loss, kind, GHOST[loss])
    step = jengine.make_train_step(jengine.make_loss_fn(
        loss, 0.5, _weights(loss), fused=True))
    snaps = []
    for batch in _batches(loss):
        state, metrics = step(state, *batch)
        snaps.append(_snapshot(state, metrics))
    return variables, snaps


def _port_state(loss, kind, variables, ghost=None):
    ghost = GHOST[loss] if ghost is None else ghost
    cfg = NameSpace({"model": {"variant": "tiny50", "bn_stats_rows": ghost}})
    model = pengine.build_model(cfg, _n_classes(loss), dtype=torch.float32)
    convert.load_into(model, convert.variables_to_state_dict(variables))
    tx = pengine.build_optimizer(NameSpace({"type": kind, "lr": LR[kind]}),
                                 1)
    return pengine.create_state(model, tx)


def _port_step(loss, bn_stats_rows=None):
    return pengine.make_train_step(
        pengine.make_loss_fn(loss, 0.5, _weights(loss), fused="auto"),
        bn_stats_rows=bn_stats_rows)


def _check(state, metrics, snap, loss_rtol=1e-4, atol=1e-5,
           params=True):
    np.testing.assert_allclose(float(metrics["loss_sum"]), snap["loss_sum"],
                               rtol=loss_rtol)
    assert float(metrics["count"]) == snap["count"]
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    for coll in ("batch_stats", "params") if params else ("batch_stats",):
        ref = convert.variables_to_state_dict({coll: snap[coll]})
        rtol = 1e-5 if coll == "batch_stats" else 0
        for key, want in ref.items():
            np.testing.assert_allclose(sd[key], want, rtol=rtol, atol=atol,
                                       err_msg=key)


def _moments(state, opt_state):
    """(port exp_avg, exp_avg_sq; JAX mu, nu) keyed like the model."""
    adam = opt_state[0]
    ref_mu = convert.variables_to_state_dict({"params": adam.mu})
    ref_nu = convert.variables_to_state_dict({"params": adam.nu})
    got = {k: state.optimizer.state[p]
           for k, p in state.model.named_parameters()}
    return got, ref_mu, ref_nu


def _ratio(got, ref, rtol=1e-4):
    """max |got - ref| / (rtol * (|ref| + max|ref|)); <= 1 passes."""
    tol = rtol * (np.abs(ref) + np.abs(ref).max())
    return float(np.max(np.abs(got - ref) / np.maximum(tol, 1e-30)))


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("loss", ["entropic", "softmax", "garbage"])
def test_steps_match_jax(loss, kind):
    variables, snaps = _jax_run(loss, kind)
    step = _port_step(loss)
    for k, batch in enumerate(_batches(loss)):
        state = _port_state(loss, kind, variables)
        if k:
            before = snaps[k - 1]
            convert.load_into(state.model, convert.variables_to_state_dict(
                {"params": before["params"],
                 "batch_stats": before["batch_stats"]}))
            convert.load_opt_state(state.optimizer, state.model,
                                   before["opt_state"])
            state.step = k
        state, metrics = step(state, *batch)
        assert state.step == k + 1
        scale = 10.0 if GHOST[loss] else 1.0
        _check(state, metrics, snaps[k], atol=1e-5 * scale,
               params=kind == "sgd")
        if kind == "adam":
            got, mu, nu = _moments(state, snaps[k]["opt_state"])
            for key, p in state.model.named_parameters():
                assert float(got[key]["step"]) == k + 1
                for name, ref in (("exp_avg", mu[key]),
                                  ("exp_avg_sq", nu[key])):
                    assert _ratio(got[key][name].numpy(), ref,
                                  1e-4 * scale) <= 1, (k, key, name)
                if k == 0:
                    g_ref = mu[key] / np.float32(0.1)
                    assert _ratio(p.grad.numpy(), g_ref,
                                  1e-4 * scale) <= 1, key


VALID = 3


def _tail_batch(seed=5):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (VALID, SIZE, SIZE, 3), np.uint8)
    labels = rng.integers(-1, 8, VALID).astype(np.int32)
    # Padded as the pipeline pads: valid rows first, recycled real images.
    pad_images = np.concatenate(
        [images, images[np.arange(BATCH - VALID) % VALID]])
    pad_labels = np.concatenate([labels, np.zeros(BATCH - VALID, np.int32)])
    mask = (np.arange(BATCH) < VALID).astype(np.float32)
    return (images, labels, np.ones(VALID, np.float32)), \
        (pad_images, pad_labels, mask)


@functools.lru_cache(maxsize=None)
def _jax_tail():
    """JAX's tail step: the same parameters through a window of VALID rows
    (``model.clone(bn_stats_rows=n_tail)``, train.py:1001-1005)."""
    model, state, variables = _jax_state("entropic", "sgd", 0)
    step = jengine.make_train_step(
        jengine.make_loss_fn("entropic", 0.5, fused=True),
        apply_fn=model.clone(bn_stats_rows=VALID).apply)
    state, metrics = step(state, *_tail_batch()[1])
    return variables, _snapshot(state, metrics)


@pytest.mark.parametrize("ghost", [0, 16])
def test_masked_tail_step(ghost):
    variables, snap = _jax_tail()
    unpadded, padded = _tail_batch()
    loss_fn = pengine.make_loss_fn("entropic", 0.5, fused="auto")

    ref = _port_state("entropic", "sgd", variables, ghost)
    ref, ref_m = pengine.make_train_step(loss_fn)(ref, *unpadded)

    state = _port_state("entropic", "sgd", variables, ghost)
    regular = pengine.make_train_step(loss_fn)
    tail = pengine.make_tail_step(loss_fn, state.model, VALID, regular)
    assert tail is not regular
    state, metrics = tail(state, *padded)
    assert state.model.bn_stats_rows == ghost  # window restored

    assert float(metrics["count"]) == VALID
    np.testing.assert_allclose(float(metrics["loss_sum"]),
                               float(ref_m["loss_sum"]), rtol=1e-5)
    for (key, a), b in zip(state.model.state_dict().items(),
                           ref.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)
    _check(state, metrics, snap)


def test_tail_rule():
    loss_fn = pengine.make_loss_fn("entropic")
    regular = pengine.make_train_step(loss_fn)
    for ghost, n_tail, same in ((2, 3, True), (3, 3, True), (4, 3, False),
                                (0, 3, False)):
        model = pengine.build_model(NameSpace({"model": {
            "variant": "tiny", "bn_stats_rows": ghost}}), 4)
        tail = pengine.make_tail_step(loss_fn, model, n_tail, regular)
        assert (tail is regular) == same, (ghost, n_tail)
    assert pengine.make_tail_step(loss_fn, model, 0, regular) is None
