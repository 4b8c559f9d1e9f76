"""The port's train slice as a whole against the JAX package's (CPU).

One epoch of ``train_epoch`` over each package's ``pipeline_from_dataset``
(the same CSV index, seed and synthetic reader), with ``make_train_step``
and the ragged-tail step, on tiny50 in float32 from shared weights, SGD
at lr 1e-3, for the three losses: 21 rows at batch 8, so two full
batches and a tail of 5 padded to 8 (softmax keeps its known rows only).
The entropic run uses a ghost window of 6 rows, wider than the tail, so
the tail-specific step runs; softmax and garbage use full-batch
statistics (their tail step takes a window of its valid rows).  Images
are 64 px: at 32 px the last stage is 1x1, and a 5-row window gives 5
values per channel, too few for float32 statistics to agree past 1e-4.
Checked: the epoch's ``j`` within rtol 1e-4 and its row count exact, and
the parameters and batch statistics after the epoch within rtol and atol
1e-4 (the steps run free, so the 1e-5 of ``tests/test_torch_train.py``,
which restarts every step from JAX's state, does not hold: a ReLU the two
runs put on opposite sides of zero moves a parameter by ~1e-5 at this
rate).
"""

from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_imagenet_tpu import dataset as jdataset
from openset_imagenet_tpu import pipeline as jpipeline
from openset_imagenet_tpu import train as jengine
from openset_imagenet_tpu.config import NameSpace as JaxNameSpace
from openset_imagenet_tpu.models.resnet import build_resnet as jax_build
from openset_imagenet_tpu.ops.losses import AverageMeter as JaxMeter
from openset_imagenet_tpu_torch import convert
from openset_imagenet_tpu_torch import dataset as pdataset
from openset_imagenet_tpu_torch import pipeline as ppipeline
from openset_imagenet_tpu_torch import train as pengine
from openset_imagenet_tpu_torch.config import NameSpace
from openset_imagenet_tpu_torch.ops.losses import AverageMeter
from tests.test_torch_model import _random_variables

SIZE, BATCH, ROWS, CLASSES, LR = 64, 8, 21, 4, 1e-3
GHOST = {"entropic": 6, "softmax": 0, "garbage": 0}


def _index(tmp_path):
    labels = np.concatenate([np.arange(CLASSES),
                             np.random.default_rng(3).integers(
                                 -1, CLASSES, ROWS - CLASSES)])
    path = tmp_path / "p1_train.csv"
    with open(path, "w") as f:
        for i, label in enumerate(labels):
            f.write(f"n{max(label, 0):02d}/img_{i:03d}.JPEG,{label}\n")
    return path


def _dataset(module, csv, loss):
    ds = module.ImagenetDataset(csv, csv.parent)
    if loss == "garbage":
        ds.replace_negative_label()
    elif loss == "softmax":
        ds.remove_negative_label()
    n = ds.label_count - 1 if loss == "entropic" else ds.label_count
    weights = ds.calculate_class_weights() if loss == "garbage" else None
    return ds, n, weights


def _jax_epoch(csv, loss):
    ds, n, weights = _dataset(jdataset, csv, loss)
    model = jax_build("tiny50", fc_layer_dim=n, out_features=n,
                      dtype=jnp.float32, bn_stats_rows=GHOST[loss])
    tx = jengine.build_optimizer(JaxNameSpace({"type": "sgd", "lr": LR}), 1)
    variables = _random_variables(model, seed=23)
    state = jengine.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), apply_fn=model.apply, tx=tx)
    loss_fn = jengine.make_loss_fn(loss, 1.0, weights, fused=True)
    step = jengine.make_train_step(loss_fn)
    n_tail = len(ds) % BATCH
    tail = (step if 0 < GHOST[loss] <= n_tail else jengine.make_train_step(
        loss_fn, apply_fn=model.clone(bn_stats_rows=n_tail).apply))
    pipe = jpipeline.pipeline_from_dataset(
        ds, BATCH, is_training=True, seed=5, num_workers=2,
        reader=jpipeline.SyntheticReader(crop=SIZE, seed=1))
    trackers = defaultdict(JaxMeter)
    state = jengine.train_epoch(state, pipe, 0, step, trackers,
                                tail_step=tail)
    pipe.close()
    return variables, trackers, jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats})


@pytest.mark.parametrize("loss", ["entropic", "softmax", "garbage"])
def test_train_epoch_matches_jax(tmp_path, loss):
    csv = _index(tmp_path)
    variables, ref_trackers, ref = _jax_epoch(csv, loss)

    ds, n, weights = _dataset(pdataset, csv, loss)
    cfg = NameSpace({"model": {"variant": "tiny50",
                               "bn_stats_rows": GHOST[loss]}})
    model = pengine.build_model(cfg, n, dtype=torch.float32)
    convert.load_into(model, convert.variables_to_state_dict(variables))
    state = pengine.create_state(model, pengine.build_optimizer(
        NameSpace({"type": "sgd", "lr": LR}), 1))
    loss_fn = pengine.make_loss_fn(loss, 1.0, weights, fused="auto")
    step = pengine.make_train_step(loss_fn)
    tail = pengine.make_tail_step(loss_fn, model, len(ds) % BATCH, step)
    assert tail is not None and tail is not step
    pipe = ppipeline.pipeline_from_dataset(
        ds, BATCH, is_training=True, seed=5, num_workers=2,
        reader=ppipeline.SyntheticReader(crop=SIZE, seed=1))
    trackers = defaultdict(AverageMeter)
    state = pengine.train_epoch(state, pipe, 0, step, trackers,
                                tail_step=tail)
    pipe.close()

    assert state.step == len(pipe) >= 2
    assert trackers["j"].count == ref_trackers["j"].count == len(ds)
    tol = 1e-4
    np.testing.assert_allclose(trackers["j"].avg, ref_trackers["j"].avg,
                               rtol=tol)
    assert trackers["imgs/s"].avg > 0
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    for key, want in convert.variables_to_state_dict(ref).items():
        np.testing.assert_allclose(sd[key], want, rtol=tol, atol=tol,
                                   err_msg=key)
