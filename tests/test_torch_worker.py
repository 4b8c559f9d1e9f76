"""The port's worker against the JAX package's, and the optimizer's
``opt.ema`` / ``opt.accumulate_steps`` against optax (CPU).

Both workers run one ``(protocol, loss)`` job from the same config: tiny50
at 64 px in float32 (each package's ``build_model`` is patched to float32
here; neither worker has a dtype knob), SGD at lr 1e-3, the synthetic
reader over an index rooted at the fixed relative path ``imagenet`` (the
reader keys each image by its full path; see ``tests/
test_torch_epoch.py``), the JAX run pinned to one device (``gpu: 0``).
Both finetune from the same reference ``.pth``, written through the
port's ``convert`` from the JAX variables that the JAX worker's own
``create_state`` draws for the run's seed: the JAX worker keeps the EMA
shadow of that draw on a finetune (``train.py:929,941``), the port starts
it from the loaded weights, and with this file the two coincide.

That draw leaves batch-norm at its initial statistics; drawn at random
(as ``tests/test_torch_epoch.py`` draws them for one epoch), the two
float32 runs drift apart over these six steps, to 5.8e-4 at the stem
conv, the float32 sensitivity ROADMAP Queue 3 records.

Cases: entropic with a ghost window of 6 rows over a 5-row tail (the
tail-specific step), 2 epochs; garbage with ``opt: {ema: 0.9,
accumulate_steps: 2}`` (full-batch statistics, the tail's own window), 2
epochs.  Compared: the ``info``
dicts (``best_score`` within rtol 1e-4; ``device_ids`` is the JAX device
list against the port's ``[]`` on the CPU), the per-epoch scalars within
rtol 1e-4 (the throughput only present), the ``epoch``, ``step`` and
``extra`` of ``_curr`` and ``_best`` exactly and their ``best_score``
within rtol 1e-4 (two float32 validations), and their weights (parameters
and batch-norm statistics) within rtol and atol 1e-4 (the JAX msgpack
files read through the JAX package's ``load_checkpoint``).
"""

import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openset_imagenet_tpu import train as jengine
from openset_imagenet_tpu.checkpoint import load_checkpoint as jax_load
from openset_imagenet_tpu.config import NameSpace as JaxNameSpace
from openset_imagenet_tpu.events import read_scalars as jax_scalars
from openset_imagenet_tpu_torch import convert
from openset_imagenet_tpu_torch import train as pengine
from openset_imagenet_tpu_torch.config import NameSpace
from openset_imagenet_tpu_torch.events import read_scalars
from tests.test_torch_epoch import _index as epoch_index
from tests.test_torch_worker_host import (  # noqa: F401 (autouse fixture)
    one_torch_thread)

SIZE, BATCH, CLASSES, SEED = 64, 8, 4, 7
ROOT = "imagenet"
CASES = {
    "entropic": {"model": {"variant": "tiny50", "bn_stats_rows": 6},
                 "opt": {"type": "sgd", "lr": 1e-3}},
    "garbage": {"model": {"variant": "tiny50"},
                "opt": {"type": "sgd", "lr": 1e-3, "ema": 0.9,
                        "accumulate_steps": 2}},
}


def _index(tmp_path):
    """The train index of ``tests/test_torch_epoch.py`` (21 rows: two
    batches of 8 and a tail of 5) and 14 val rows, every class and the
    negatives in both."""
    epoch_index(tmp_path)
    rng = np.random.default_rng(3)
    labels = np.concatenate([np.arange(-1, CLASSES),
                             rng.integers(-1, CLASSES, 9)])
    with open(tmp_path / "p1_val.csv", "w", newline="") as f:
        csv.writer(f).writerows(
            (f"n{max(label, 0):02d}/val_{i:03d}.JPEG", label)
            for i, label in enumerate(labels))


def _cfg(tmp_path, loss, out, finetune):
    spec = CASES[loss]
    return {
        "name": loss, "checkpoint": str(finetune), "log_name": "train.log",
        "train_mode": "finetune", "gpu": 0, "parallel": True,
        "data": {"imagenet_path": ROOT,
                 "train_file": str(tmp_path / "p{}_train.csv"),
                 "val_file": str(tmp_path / "p{}_val.csv"),
                 "reader": "synthetic", "image_size": SIZE},
        "seed": SEED, "batch_size": BATCH, "epochs": 2, "workers": 2,
        "patience": 0, "loss": {"type": loss, "w": 1.0},
        "opt": spec["opt"], "model": spec["model"], "protocol": 1,
        "output_directory": tmp_path / out}


def _start_file(tmp_path, loss):
    """The reference .pth both workers finetune from (see the module
    docstring)."""
    n = CLASSES if loss == "entropic" else CLASSES + 1
    cfg = JaxNameSpace(_cfg(tmp_path, loss, "unused", None))
    model = jengine.build_model(cfg, n)
    tx = jengine.build_optimizer(cfg.opt, 1)
    state = jengine.create_state(model, jengine.set_seeds(SEED), tx,
                                 image_size=SIZE)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    path = tmp_path / f"start_{loss}.pth"
    torch.save({"model_state_dict": {
        k: torch.tensor(v) for k, v in
        convert.variables_to_state_dict(variables).items()},
        "epoch": 0, "best_score": 0.0}, path)
    return path


@pytest.fixture
def float32_models(monkeypatch):
    jax_build, port_build = jengine.build_model, pengine.build_model
    monkeypatch.setattr(jengine, "build_model", lambda cfg, n: jax_build(
        cfg, n).clone(dtype=jnp.float32))
    monkeypatch.setattr(pengine, "build_model", lambda cfg, n, **kw:
                        port_build(cfg, n, dtype=torch.float32, **kw))


def _jax_file(path, cfg, n):
    model = jengine.build_model(cfg, n)
    tx = jengine.build_optimizer(cfg.opt, 1)
    template = jengine.create_state(model, jax.random.PRNGKey(0), tx,
                                    image_size=SIZE)
    state, epoch, best, extra = jax_load(path, template, return_extra=True)
    weights = convert.variables_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    return {"epoch": epoch, "step": int(state.step), "best_score": best,
            "extra": extra}, weights


def _port_file(path):
    payload = torch.load(path, weights_only=True)
    meta = {k: payload[k] for k in ("epoch", "step", "best_score")}
    meta["extra"] = payload.get("extra", {})
    return meta, {k: v.numpy() for k, v in
                  payload["model_state_dict"].items()}


@pytest.mark.parametrize("loss", ["entropic", "garbage"])
def test_worker_matches_jax(tmp_path, float32_models, loss):
    _index(tmp_path)
    start = _start_file(tmp_path, loss)
    jcfg = JaxNameSpace(_cfg(tmp_path, loss, "jax", start))
    pcfg = NameSpace(_cfg(tmp_path, loss, "port", start))
    ref = jengine.worker(jcfg)
    got = pengine.worker(pcfg, device="cpu")

    assert ref["device_ids"] == [0] and got["device_ids"] == []
    for key in ("n_classes", "last_epoch", "stopped_mid_epoch"):
        assert got[key] == ref[key], key
    assert got["best_score"] == pytest.approx(ref["best_score"], rel=1e-4)
    assert got["last_epoch"] == 1

    ref_scalars = jax_scalars(jcfg.output_directory)
    got_scalars = read_scalars(pcfg.output_directory)
    assert set(got_scalars) == set(ref_scalars) == {
        "train/loss", "val/loss", "val/conf_kn", "val/conf_unk",
        "train/imgs_per_sec"}
    for tag, series in ref_scalars.items():
        assert [s for s, _ in got_scalars[tag]] == [0, 1], tag
        if tag != "train/imgs_per_sec":
            np.testing.assert_allclose([v for _, v in got_scalars[tag]],
                                       [v for _, v in series], rtol=1e-4,
                                       err_msg=tag)

    n = ref["n_classes"]
    for kind in ("curr", "best"):
        ref_meta, ref_w = _jax_file(
            Path(jcfg.output_directory) / f"{loss}_{kind}.pth", jcfg, n)
        got_meta, got_w = _port_file(
            Path(pcfg.output_directory) / f"{loss}_{kind}.pth")
        for key in ("epoch", "step", "extra"):
            assert got_meta[key] == ref_meta[key], (kind, key)
        assert got_meta["best_score"] == pytest.approx(
            ref_meta["best_score"], rel=1e-4), kind
        assert set(got_w) == set(ref_w)
        for key, value in ref_w.items():
            np.testing.assert_allclose(got_w[key], value, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{kind} {key}")


@pytest.mark.parametrize("kind", ["adam", "sgd"])
@pytest.mark.parametrize("accumulate", [1, 3])
def test_ema_and_accumulation_match_optax(kind, accumulate):
    """``opt.ema`` (0.9) and ``opt.accumulate_steps`` over seven micro-steps
    of random gradients: parameters, EMA shadow and counters against
    optax's chain(tx, weight_ema) inside MultiSteps, with a StepLR decay
    that the update count drives."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(7)]
    cfg = {"type": kind, "lr": 1e-2, "decay": 1, "gamma": 0.5, "ema": 0.9,
           "accumulate_steps": accumulate}
    tx = jengine.build_optimizer(JaxNameSpace(cfg), steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
    ref_ema = jengine.extract_ema(opt_state)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    ptx = pengine.build_optimizer(NameSpace(cfg), steps_per_epoch=2)
    state = pengine.TrainState(None, ptx.make(list(tp.values())),
                               ptx.schedule, accumulate_steps=accumulate,
                               ema_decay=ptx.ema)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        state.apply_gradients()
    assert state.step == 7
    assert state.updates == 7 // accumulate
    assert state.mini_step == 7 % accumulate
    for i, k in enumerate(tp):
        assert np.abs(tp[k].detach().numpy() - params[k]).max() > 1e-3, k
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(state.ema[i].numpy(),
                                   np.asarray(ref_ema[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"ema {k}")
    if accumulate > 1:
        mid = opt_state.acc_grads
        for i, k in enumerate(tp):
            np.testing.assert_allclose(state.acc_grads[i].numpy(),
                                       np.asarray(mid[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"acc {k}")
