"""The port's work after training against the JAX package's (CPU).

One module fixture trains each loss for one epoch with the port's worker
(``tests/test_torch_worker_host.py``'s ``tiny`` runs at 32 px: 36 train
rows, 28 val and 28 test rows with -1 and -2, the synthetic reader) into
a ``Protocol_1`` layout, and copies the ``_curr`` / ``_best`` files into
a second one for the JAX package.  Then:

* **evaluate**: the JAX ``script/evaluate.main`` (with ``--model-variant
  tiny``: it reads no arch from a ``.pth``) and the port's (without it:
  the arch comes from the checkpoint) on the same files, CSVs and reader,
  for the three losses and both files, with both packages' models in
  float32 and in bfloat16 (the default).  ``gt`` equal in both.  float32:
  logits and features within rtol 1e-4 / atol 1e-4 * max|ref| and scores
  within 1e-4, the serving slice's tolerance.  bfloat16: the JAX CLI's
  jitted forward rounds fused elementwise chains once where the port
  rounds each op (the port is bit-equal to flax run op by op, ``tests/
  test_torch_model.py``), so the rule is the model test's: scores within
  2e-2 (logits and features within 2e-2 * max|ref|) and a class decision
  flipped only at a near-tie.  The n_classes rule and the no-surgery
  labels hold.
* ``get_arrays`` on an empty split: the JAX shapes and dtypes.
* the arch repair: ``infer_arch`` / ``resolve_model_cfg`` on port and
  reference files, and ``OpenSetPredictor`` rebuilding a ``tiny`` port
  checkpoint without ``variant=``.
* **plot_all**: the ``.tex`` table of the port's CLI over the port's
  archives text-equal to the JAX CLI's over the same archives (both
  write their PDF too); the port's ``load_scores(--force)`` re-extracts
  through its child process on the CPU.
* **train_all**: ``--dry-run`` gives per-run YAMLs equal to the JAX
  CLI's and commands that name the port's module; a real tiny sweep of
  one run trains through the child process.
"""

import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from openset_imagenet_tpu_torch import checkpoint as ckpt
from openset_imagenet_tpu_torch import train as engine
from openset_imagenet_tpu_torch.config import NameSpace
from tests.test_torch_worker_host import (  # noqa: F401 (autouse fixture)
    one_torch_thread, tiny_cfg, write_protocol_csvs)

LOSSES = ("entropic", "softmax", "garbage")
DTYPES = ("bfloat16", "float32")
SIZE = 32


def _eval_args(loss, root, out, extra=()):
    return [loss, "1", *extra,
            "--imagenet-directory", str(root),
            "--protocol-directory", str(root),
            "--output-directory", str(out),
            "--batch-size", "8", "--workers", "2",
            "--image-size", str(SIZE), "--reader", "synthetic"]


def _float32_models(mp):
    """Both packages' ``build_model`` in float32 (neither CLI has a dtype
    flag)."""
    from openset_imagenet_tpu import train as jengine

    jax_build, port_build = jengine.build_model, engine.build_model
    mp.setattr(jengine, "build_model", lambda cfg, n: jax_build(
        cfg, n).clone(dtype=jax.numpy.float32))
    mp.setattr(engine, "build_model", lambda cfg, n, **kw: port_build(
        cfg, n, dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Port-trained runs; archives of both packages' evaluate, with the
    models in bfloat16 (the default) and in float32."""
    from openset_imagenet_tpu.script.evaluate import main as jax_evaluate
    from openset_imagenet_tpu_torch.script.evaluate import main as evaluate

    root = tmp_path_factory.mktemp("evaluate")
    write_protocol_csvs(root)
    dirs = {(pkg, dtype): root / f"{pkg}_{dtype}" / "Protocol_1"
            for pkg in ("port", "jax") for dtype in DTYPES}
    for d in dirs.values():
        d.mkdir(parents=True)
    port = dirs["port", "bfloat16"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for loss in LOSSES:
            cfg = tiny_cfg(root, loss, epochs=1)
            cfg.output_directory = port
            cfg.log_name = f"{loss}.log"
            engine.worker(cfg, device="cpu")
            for d in dirs.values():
                if d != port:
                    for suffix in ("_curr", "_best"):
                        shutil.copy(port / f"{loss}{suffix}.pth", d)
        for dtype in DTYPES:
            with pytest.MonkeyPatch.context() as mp:
                if dtype == "float32":
                    _float32_models(mp)
                for loss in LOSSES:
                    for extra in ([], ["--use-best"]):
                        written = evaluate(
                            _eval_args(loss, root, dirs["port", dtype],
                                       extra) + ["--device", "cpu"])
                        assert set(written) == {"val", "test"}
                        jax_evaluate(
                            _eval_args(loss, root, dirs["jax", dtype], extra)
                            + ["--model-variant", "tiny"])
    finally:
        torch.set_num_threads(threads)
    return root, dirs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("suffix", ["_curr", "_best"])
@pytest.mark.parametrize("loss", LOSSES)
def test_evaluate_matches_jax(runs, loss, suffix, dtype):
    root, dirs = runs
    for split in ("val", "test"):
        name = f"{loss}_{split}_arr{suffix}.npz"
        got = np.load(dirs["port", dtype] / name)
        want = np.load(dirs["jax", dtype] / name)
        assert set(got.files) == set(want.files) == {
            "gt", "logits", "features", "scores"}
        for key in got.files:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got["gt"], want["gt"])
        if dtype == "float32":
            # The serving slice's float32 tolerance (summation order).
            for key in ("logits", "features"):
                np.testing.assert_allclose(
                    got[key], want[key], rtol=1e-4,
                    atol=1e-4 * np.abs(want[key]).max(), err_msg=key)
            np.testing.assert_allclose(got["scores"], want["scores"],
                                       rtol=1e-4, atol=1e-4)
        else:
            # bfloat16: the model test's rule (tests/test_torch_model.py):
            # scores within 2e-2, a class decision flipped only at a
            # near-tie.  The jitted JAX forward rounds its fused
            # elementwise chains once where the port (and flax run op by
            # op, which the port matches bit for bit) rounds each op.
            for key in ("logits", "features"):
                np.testing.assert_allclose(
                    got[key], want[key], rtol=0,
                    atol=2e-2 * np.abs(want[key]).max(), err_msg=key)
            np.testing.assert_allclose(got["scores"], want["scores"],
                                       rtol=0, atol=2e-2)
            top2 = np.sort(want["scores"], axis=-1)[:, -2:]
            flipped = np.nonzero(got["scores"].argmax(-1)
                                 != want["scores"].argmax(-1))[0]
            for i in flipped:
                assert top2[i, 1] - top2[i, 0] < 2e-2, (i, top2[i])
        # No label surgery, the n_classes rule (3 knowns; garbage + 1),
        # every CSV row once.
        rows = (root / f"p1_{split}.csv").read_text().splitlines()
        labels = [int(r.rsplit(",", 1)[1]) for r in rows]
        np.testing.assert_array_equal(got["gt"], np.float32(labels))
        assert got["gt"].dtype == np.float32
        assert got["scores"].shape == (len(rows),
                                       4 if loss == "garbage" else 3)
        np.testing.assert_allclose(got["scores"].sum(1), 1.0, atol=1e-5)


class _Empty:
    def epoch(self, epoch):
        return iter(())


def test_get_arrays_empty_split_matches_jax():
    import optax

    from openset_imagenet_tpu import train as jengine
    from openset_imagenet_tpu.config import NameSpace as JaxNameSpace

    cfg = {"model": {"variant": "tiny"}}
    jmodel = jengine.build_model(JaxNameSpace(cfg), 5)
    state = jengine.create_state(jmodel, jax.random.PRNGKey(0),
                                 optax.identity(), image_size=SIZE)
    want = jengine.get_arrays(state, _Empty(), gather=False)
    model = engine.build_model(NameSpace(cfg), 5, device="cpu")
    got = engine.get_arrays(model, _Empty())
    assert [(a.shape, a.dtype) for a in got] == \
        [(a.shape, a.dtype) for a in want] == [
            ((0,), np.float32), ((0, 5), np.float32),
            ((0, 5), np.float32), ((0, 5), np.float32)]


def test_get_arrays_drops_masked_rows(runs, monkeypatch):
    """A masked row anywhere in a batch is dropped; labels are float32."""
    port = runs[1]["port", "bfloat16"]
    model = engine.build_model(NameSpace({"model": {"variant": "tiny"}}),
                               3, device="cpu")
    ckpt.load_checkpoint(port / "entropic_curr.pth", model)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 8, SIZE, SIZE, 3), np.uint8)
    labels = rng.integers(-2, 3, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.float32)
    mask[0, 3] = mask[1, 5:] = 0
    pipe = types.SimpleNamespace(epoch=lambda e: iter(
        [types.SimpleNamespace(images=images[i], labels=labels[i],
                               mask=mask[i]) for i in range(2)]))
    gt, logits, features, scores = engine.get_arrays(model, pipe)
    keep = mask.reshape(-1) > 0
    np.testing.assert_array_equal(gt, labels.reshape(-1)[keep])
    assert gt.dtype == np.float32 and logits.shape == (keep.sum(), 3)
    full_logits, full_features, _ = engine.make_forward_step()(
        model, images.reshape(-1, SIZE, SIZE, 3))
    np.testing.assert_array_equal(logits, full_logits.numpy()[keep])
    np.testing.assert_array_equal(features, full_features.numpy()[keep])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 8"):
        engine.get_arrays(model, pipe)


def test_arch_read_back(runs, tmp_path):
    path = runs[1]["port", "bfloat16"] / "entropic_best.pth"
    assert ckpt.infer_arch(path) == {"variant": "tiny",
                                     "space_to_depth": False}
    assert ckpt.resolve_model_cfg(path) == {"variant": "tiny",
                                            "space_to_depth": False}
    assert ckpt.resolve_model_cfg(path, "resnet18")["variant"] == "resnet18"
    # A reference .pth (no extra), a missing file and a non-torch file
    # give {}: resnet50.
    payload = torch.load(path, weights_only=True)
    ref = tmp_path / "reference.pth"
    torch.save({"model_state_dict": payload["model_state_dict"],
                "epoch": 1, "best_score": 0.5}, ref)
    junk = tmp_path / "native.pth"
    junk.write_bytes(b"\x85\xa5epoch\x01")
    for other in (ref, tmp_path / "missing.pth", junk):
        assert ckpt.infer_arch(other) == {}
        assert ckpt.resolve_model_cfg(other) == {"variant": "resnet50",
                                                 "space_to_depth": False}


def test_predictor_rebuilds_port_checkpoint_without_variant(runs):
    from openset_imagenet_tpu_torch.inference import OpenSetPredictor

    path = runs[1]["port", "bfloat16"] / "entropic_curr.pth"
    pred = OpenSetPredictor(path, image_size=SIZE, device="cpu")
    tiny = engine.build_model(NameSpace({"model": {"variant": "tiny"}}), 3,
                              device="cpu")
    assert [t.shape for t in pred.model.state_dict().values()] == \
        [t.shape for t in tiny.state_dict().values()]
    images = np.random.default_rng(1).integers(0, 256, (3, SIZE, SIZE, 3),
                                               np.uint8)
    _, _, _, scores = pred.predict(images, return_arrays=True)
    ckpt.load_checkpoint(path, tiny)
    _, _, want = engine.make_forward_step()(tiny, images)
    np.testing.assert_array_equal(scores, want.numpy())


def _plot_args(out, root, table, pdf, *extra):
    return ["--protocols", "1", "--loss-functions", *LOSSES,
            "--labels", "EOS", "S", "BG", *extra,
            "--output-directory", str(out.parent),
            "--imagenet-directory", str(root),
            "--protocol-directory", str(root),
            "--table", str(table), "--plots", str(pdf)]


def test_plot_table_matches_jax(runs, tmp_path):
    from openset_imagenet_tpu.script.plot_all import main as jax_plot
    from openset_imagenet_tpu_torch.script.plot_all import main as plot

    root, dirs = runs
    port = dirs["port", "bfloat16"]
    plot(_plot_args(port, root, tmp_path / "port.tex", tmp_path / "p.pdf"))
    jax_plot(_plot_args(port, root, tmp_path / "jax.tex",
                        tmp_path / "j.pdf"))
    table = (tmp_path / "port.tex").read_text()
    assert table == (tmp_path / "jax.tex").read_text()
    assert table.count("\\\\") == 3 and "$P_1$ - BG &" in table
    assert (tmp_path / "p.pdf").stat().st_size > 0


def test_plot_all_extracts_through_its_child(runs, tmp_path):
    """``load_scores`` with ``--force`` runs the port's evaluate in a child
    process, on the device it is given, and reads what it wrote."""
    from openset_imagenet_tpu_torch.script import plot_all

    root, dirs = runs
    port = dirs["port", "bfloat16"]
    out = tmp_path / "exp" / "Protocol_1"
    out.mkdir(parents=True)
    shutil.copy(port / "softmax_curr.pth", out)
    args = plot_all.get_args(
        ["--protocols", "1", "--loss-functions", "softmax", "--labels", "S",
         "--force", "--device", "cpu", "--reader", "synthetic",
         "--output-directory", str(out.parent),
         "--imagenet-directory", str(root),
         "--protocol-directory", str(root)])
    scores, epochs = plot_all.load_scores(args)
    test = scores[1]["softmax"]["test"]
    rows = len((root / "p1_test.csv").read_text().splitlines())
    assert test["scores"].shape == (rows, 3)
    np.testing.assert_allclose(test["scores"].sum(1), 1.0, atol=1e-5)
    assert epochs[1]["softmax"] == (
        ckpt.read_metadata(out / "softmax_curr.pth")["epoch"],
        ckpt.read_metadata(out / "softmax_curr.pth")["best_score"])


def _sweep_args(cfg_file, out, *extra):
    return ["--configuration", str(cfg_file), "--protocols", "1",
            "--loss-functions", "softmax", "entropic",
            "--output-directory", str(out), *extra]


def test_train_all_dry_run_matches_jax(runs, tmp_path, capsys):
    from openset_imagenet_tpu.script.train_all import main as jax_sweep
    from openset_imagenet_tpu_torch.script.train_all import main as sweep

    root, dirs = runs
    port = dirs["port", "bfloat16"]
    cfg_file = tmp_path / "sweep.yaml"
    cfg_file.write_text(tiny_cfg(root, "entropic", epochs=1).dump())
    for gpus in ([], ["--gpus", "0", "1"]):
        jax_sweep(_sweep_args(cfg_file, tmp_path / "jax", "--dry-run",
                              *gpus))
        capsys.readouterr()
        sweep(_sweep_args(cfg_file, tmp_path / "port", "--dry-run", *gpus,
                          "--device", "cpu"))
        lines = capsys.readouterr().out.strip().splitlines()
        for loss in ("softmax", "entropic"):
            name = Path("Protocol_1") / f"{loss}.yaml"
            assert (tmp_path / "port" / name).read_text() == \
                (tmp_path / "jax" / name).read_text()
    assert len(lines) == 2
    for line, gpu in zip(lines, ("0", "1")):
        words = line.split()
        assert words[1:3] == ["-m", "openset_imagenet_tpu_torch.script.train"]
        assert words[-4:] == ["--device", "cpu", "--gpu", gpu]
    # --continue-training points a run at its _curr.
    sweep(["--configuration", str(cfg_file), "--protocols", "1",
           "--loss-functions", "entropic", "--output-directory",
           str(port.parent), "--continue-training", "--dry-run"])
    from openset_imagenet_tpu_torch.config import load_yaml
    assert load_yaml(port / "entropic.yaml").checkpoint == \
        str(port / "entropic_curr.pth")


def test_train_all_runs_a_tiny_sweep(runs, tmp_path):
    root = runs[0]
    cfg_file = tmp_path / "sweep.yaml"
    cfg_file.write_text(tiny_cfg(root, "garbage", epochs=1).dump())
    subprocess.run(
        [sys.executable, "-m", "openset_imagenet_tpu_torch.script.train_all",
         "--configuration", str(cfg_file), "--protocols", "1",
         "--loss-functions", "garbage", "--output-directory",
         str(tmp_path / "exp"), "--nice", "0", "--device", "cpu"],
        check=True, timeout=300, capture_output=True)
    run_dir = tmp_path / "exp" / "Protocol_1"
    meta = ckpt.read_metadata(run_dir / "garbage_curr.pth")
    assert meta["epoch"] == 1 and meta["extra"]["arch"]["variant"] == "tiny"
    assert "Training finished" in (run_dir / "garbage.log").read_text()
