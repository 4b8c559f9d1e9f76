"""The port's worker on the CPU (port only): runs, surgery, resume.

Each test mirrors one of the JAX package's ``tests/test_engine.py`` on
its own worker: label surgery and n_classes for the three losses (with
the files, the scalar record and the γ of ``_curr`` / ``_best``), an
epoch resume, finetune, the default device, the modes that wait for the
multi-GPU slice, the fused-blocks tail rule and the CLI.  Runs go through
``worker(cfg, device="cpu")`` on the ``tiny`` variant at 32 px with the
synthetic reader: 36 train rows at batch 8, so five batches an epoch with
a tail of 4 rows.  The helpers here serve the other worker files too:
``tests/test_torch_worker_resume.py`` (resumes bit for bit, step
budgets), ``tests/test_torch_worker_preempt.py`` (SIGTERM, geometry,
budget, early stopping, profile) and ``tests/test_torch_checkpoint.py``
(checkpoints, config, scalars, the native reader).
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from openset_imagenet_tpu_torch import checkpoint as ckpt
from openset_imagenet_tpu_torch import train as engine
from openset_imagenet_tpu_torch.config import NameSpace
from openset_imagenet_tpu_torch.events import read_scalars

TAGS = ("train/loss", "val/loss", "val/conf_kn", "val/conf_unk",
        "train/imgs_per_sec")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs (restored after): the tiny
    models' CPU ops run faster so, and the test processes that run side
    by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_protocol_csvs(tmp_path, n_train=32, n_val=24, n_known=3):
    """Tiny protocol CSVs: labels 0..n_known-1 and -1 negatives (the JAX
    ``tests/test_engine.py`` index: 36 train rows, 28 val rows)."""
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_val)):
        low = -2 if split == "test" else -1
        rows = [(f"n000/{split}_{i}.JPEG", int(rng.integers(low, n_known)))
                for i in range(n)]
        rows += [(f"n000/{split}_extra{c}.JPEG", c)
                 for c in range(low, n_known)]
        with open(tmp_path / f"p1_{split}.csv", "w", newline="") as f:
            csv.writer(f).writerows(rows)


def tiny_cfg(tmp_path, loss_type="entropic", epochs=2, out="out", **over):
    cfg = NameSpace({
        "name": loss_type, "checkpoint": None, "log_name": "training.log",
        "train_mode": "train", "gpu": None,
        "data": {"imagenet_path": str(tmp_path),
                 "train_file": str(tmp_path / "p{}_train.csv"),
                 "val_file": str(tmp_path / "p{}_val.csv"),
                 "reader": "synthetic", "image_size": 32},
        "seed": 42, "batch_size": 8, "epochs": epochs, "workers": 2,
        "patience": 0, "loss": {"type": loss_type, "w": 1.0},
        "opt": {"type": "adam", "lr": 1e-3, "decay": 0, "gamma": 1},
        "model": {"variant": "tiny"}, "protocol": 1,
        "output_directory": Path(tmp_path / out)})
    for k, v in over.items():
        setattr(cfg, k, NameSpace(v) if isinstance(v, dict) else v)
    return cfg


def run(cfg):
    return engine.worker(cfg, device="cpu")


def curr_of(cfg):
    return Path(cfg.output_directory) / f"{cfg.name}_curr.pth"


def assert_files_equal(a, b):
    """Two checkpoints hold the same state, bit for bit."""
    pa, pb = torch.load(a, weights_only=True), torch.load(b, weights_only=True)
    assert pa["step"] == pb["step"] and pa.get("updates") == pb.get("updates")

    def flat(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            yield prefix, tree
        elif isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from flat(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from flat(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    for section in ("model_state_dict", "opt_state_dict", "ema_state_dict",
                    "accumulation"):
        la, lb = list(flat(pa.get(section))), list(flat(pb.get(section)))
        assert [k for k, _ in la] == [k for k, _ in lb], section
        for (k, x), (_, y) in zip(la, lb):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), (section, k)
            else:
                assert x == y, (section, k)


# -- the worker: surgery, files, resume, finetune (tests/test_engine.py) ----

@pytest.mark.parametrize("loss_type,n_classes", [
    ("entropic", 3), ("softmax", 3), ("garbage", 4)])
def test_label_surgery_and_n_classes(tmp_path, monkeypatch, loss_type,
                                     n_classes):
    write_protocol_csvs(tmp_path)
    built = []
    real = engine.pipeline_from_dataset

    def spy(ds, batch, is_training, **kwargs):
        built.append((is_training, ds.labels.copy(), kwargs))
        return real(ds, batch, is_training, **kwargs)

    monkeypatch.setattr(engine, "pipeline_from_dataset", spy)
    cfg = tiny_cfg(tmp_path, loss_type)
    info = run(cfg)
    assert info["n_classes"] == n_classes and info["last_epoch"] == 1
    assert info["stopped_mid_epoch"] is None and info["device_ids"] == []
    (_, train, train_kw), (_, val, _) = built
    assert not train_kw["pin_memory"]  # pinned only for a CUDA device
    if loss_type == "softmax":      # negatives leave the train set only
        assert train.min() >= 0 and len(train) < 36 and (val == -1).any()
    elif loss_type == "garbage":    # -1 becomes the extra class, both sets
        assert train.min() == val.min() == 0 and train.max() == 3
    else:
        assert (train == -1).any() and (val == -1).any()
    out = Path(cfg.output_directory)
    for f in (f"{loss_type}_curr.pth", f"{loss_type}_best.pth",
              "training.log"):
        assert (out / f).exists(), f
    assert "train_len:" in (out / "training.log").read_text()
    scalars = read_scalars(out)
    for tag in TAGS:
        assert tag in scalars and len(scalars[tag]) == 2, (tag, scalars)
    meta = ckpt.read_metadata(curr_of(cfg))
    assert meta["epoch"] == 2 and meta["extra"] == {
        "arch": {"variant": "tiny", "space_to_depth": False}}
    gamma = [kn + unk for (_, kn), (_, unk) in zip(scalars["val/conf_kn"],
                                                   scalars["val/conf_unk"])]
    # _curr stores the epoch's own score; _best the best one so far.
    assert meta["best_score"] == pytest.approx(gamma[-1], rel=1e-6)
    assert info["best_score"] == pytest.approx(max(gamma), rel=1e-6)
    assert ckpt.read_metadata(out / f"{loss_type}_best.pth")[
        "best_score"] == pytest.approx(max(gamma), rel=1e-6)


def test_worker_resume(tmp_path):
    """Resume at an epoch boundary, with synchronous checkpoint writes."""
    write_protocol_csvs(tmp_path)
    run(tiny_cfg(tmp_path, epochs=1, async_checkpoint=False))
    cfg = tiny_cfg(tmp_path, epochs=2, async_checkpoint=False,
                   checkpoint=str(curr_of(tiny_cfg(tmp_path))))
    info = run(cfg)
    assert info["last_epoch"] == 1  # resumed at epoch 1, trained one more
    assert ckpt.read_metadata(curr_of(cfg))["epoch"] == 2


def test_worker_finetune_resets_best(tmp_path):
    """Finetune loads the weights only, starts at the file's epoch with a
    fresh optimizer and best 0 (reference train.py:374-380)."""
    write_protocol_csvs(tmp_path)
    first = tiny_cfg(tmp_path, epochs=1)
    run(first)
    cfg = tiny_cfg(tmp_path, epochs=2, out="out2", train_mode="finetune",
                   checkpoint=str(curr_of(first)))
    info = run(cfg)
    assert info["last_epoch"] == 1 and np.isfinite(info["best_score"])
    log = (Path(cfg.output_directory) / "training.log").read_text()
    assert "Best score of loaded model: 0.000" in log
    payload = torch.load(curr_of(cfg), weights_only=True)
    assert payload["step"] == 5  # one epoch on a fresh optimizer


def test_worker_device_defaults_to_the_card(tmp_path):
    write_protocol_csvs(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    with pytest.raises((AssertionError, RuntimeError)):
        engine.worker(tiny_cfg(tmp_path))


@pytest.mark.parametrize("over", [
    {"parallel_mode": "shard_map"},
    {"opt": {"type": "adam", "lr": 1e-3, "zero1": True}}])
def test_multi_gpu_modes_raise(tmp_path, over):
    write_protocol_csvs(tmp_path)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        run(tiny_cfg(tmp_path, **over))


def test_multi_process_run_raises(tmp_path, monkeypatch):
    write_protocol_csvs(tmp_path)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        run(tiny_cfg(tmp_path))


def test_fused_blocks_drop_the_tail(tmp_path):
    """A fused_blocks model trains no ragged tail (JAX train.py:905-909):
    four full batches an epoch, the four tail rows dropped."""
    write_protocol_csvs(tmp_path)
    cfg = tiny_cfg(tmp_path, epochs=1, model={
        "variant": "tiny50", "bn_stats_rows": 4, "fused_blocks": True,
        "boundary_mask": True})
    run(cfg)
    assert ckpt.read_metadata(curr_of(cfg))["step"] == 4
    assert "dropping the ragged tail" in (
        Path(cfg.output_directory) / "training.log").read_text()


# -- the CLI -----------------------------------------------------------------


def test_cli_trains_on_the_cpu(tmp_path):
    from openset_imagenet_tpu_torch.script import train as cli

    write_protocol_csvs(tmp_path)
    cfg = tiny_cfg(tmp_path, epochs=1)
    path = tmp_path / "train.yaml"
    path.write_text(cfg.dump())
    info = cli.main([str(path), "1", "-o", str(tmp_path / "cli"),
                     "--nice", "0", "--device", "cpu"])
    assert info["last_epoch"] == 0 and info["device_ids"] == []
    assert (tmp_path / "cli" / "entropic_curr.pth").exists()
    assert cli.get_args([str(path), "2", "-g", "1"]).gpu == 1
