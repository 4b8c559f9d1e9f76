"""The port's checkpoints and host modules (CPU, port only).

Mirrors the JAX package's ``tests/test_checkpoint_async.py`` (the
background writer: byte-identical to the synchronous save, FIFO, a
snapshot isolated from a later in-place update, error surfacing, save
after close, the bounded queue, close draining) and adds the atomic
write, the load contract (missing file, shapes, the ``TrainState``
fields, finetune, metadata, a msgpack file), ``EarlyStopping``,
``NameSpace.dump``, the scalar record, and the native JPEG batch reader
against the JAX package's, bit for bit.
"""

import numpy as np
import pytest
import torch

from openset_imagenet_tpu_torch import checkpoint as ckpt
from openset_imagenet_tpu_torch import pipeline as ppipeline
from openset_imagenet_tpu_torch import train as engine
from openset_imagenet_tpu_torch.config import NameSpace, load_yaml
from openset_imagenet_tpu_torch.events import SummaryWriter, read_scalars
from openset_imagenet_tpu_torch.ops.losses import EarlyStopping
from tests.test_torch_worker_host import (  # noqa: F401 (autouse fixture)
    one_torch_thread, tiny_cfg)


def test_early_stopping_patience():
    stop = EarlyStopping(patience=2)
    for score, done in ((1.0, False), (1.2, False), (1.1, False),
                        (1.15, True)):
        stop(metrics=score, loss=False)
        assert stop.early_stop is done
    loss = EarlyStopping(patience=1, delta=0.1)
    loss(metrics=2.0)
    loss(metrics=1.95)  # a loss must fall by more than delta
    assert loss.early_stop


def test_namespace_dump_round_trip(tmp_path):
    cfg = tiny_cfg(tmp_path)
    path = tmp_path / "cfg.yaml"
    path.write_text(cfg.dump())
    again = load_yaml(path)
    assert again.output_directory == str(cfg.output_directory)
    again.output_directory = cfg.output_directory
    assert again == cfg


def test_read_scalars_round_trip(tmp_path):
    w = SummaryWriter(tmp_path, filename_suffix="-run.log")
    for step in range(3):
        w.add_scalar("val/loss", 1.0 / (step + 1), step)
    w.add_scalar("val/loss", 0.25, 2)  # a resumed epoch: last write wins
    w.close()
    assert read_scalars(tmp_path)["val/loss"] == [
        (0, 1.0), (1, 0.5), (2, 0.25)]
    assert (tmp_path / "scalars-run.log.csv").exists()
    assert read_scalars(tmp_path, suffix_filter="-other") == {}


@pytest.fixture
def state():
    model = engine.build_model(NameSpace({"model": {"variant": "tiny"}}), 4,
                               dtype=torch.float32, device="cpu")
    tx = engine.build_optimizer(NameSpace({"type": "adam", "lr": 1e-3,
                                           "ema": 0.5,
                                           "accumulate_steps": 2}), 1)
    s = engine.create_state(model, tx)
    step = engine.make_train_step(engine.make_loss_fn("entropic"))
    rng = np.random.default_rng(0)
    for _ in range(3):
        step(s, rng.integers(0, 256, (4, 32, 32, 3), np.uint8),
             rng.integers(-1, 4, 4).astype(np.int32), np.ones(4, np.float32))
    return s


def test_async_write_is_byte_identical_to_sync(tmp_path, state):
    ckpt.save_checkpoint(tmp_path / "sync.pth", state, 4, 1.25,
                         extra={"arch": {"variant": "tiny"}})
    w = ckpt.AsyncCheckpointer()
    w.save(tmp_path / "async.pth", state, 4, 1.25,
           extra={"arch": {"variant": "tiny"}})
    w.close()
    assert (tmp_path / "async.pth").read_bytes() == \
        (tmp_path / "sync.pth").read_bytes()


def test_fifo_order_last_write_wins(tmp_path, state):
    f = tmp_path / "curr.pth"
    w = ckpt.AsyncCheckpointer()
    for epoch in range(6):
        w.save(f, state, epoch, float(epoch))
    w.wait()
    meta = ckpt.read_metadata(f)
    assert meta["epoch"] == 6 and meta["best_score"] == 5.0
    w.close()


def test_snapshot_isolation_from_an_in_place_update(tmp_path, state):
    """The queued snapshot does not see the optimizer's in-place update
    made after save() returned."""
    f = tmp_path / "snap.pth"
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    ema = [e.clone() for e in state.ema]
    w = ckpt.AsyncCheckpointer()
    w.save(f, state, 0, 0.0)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for e in state.ema:
            e.add_(1.0)
    w.close()
    payload = torch.load(f, weights_only=True)
    for k, v in before.items():
        assert torch.equal(payload["model_state_dict"][k], v), k
    for (name, _), e in zip(state.model.named_parameters(), ema):
        assert torch.equal(payload["ema_state_dict"][name], e), name


def test_writer_error_surfaces_on_wait(tmp_path, state):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("occupied")  # the writer's mkdir fails under it
    w = ckpt.AsyncCheckpointer()
    w.save(blocker / "x" / "ckpt.pth", state, 0, 0.0)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        w.wait()
    ok = tmp_path / "ok.pth"  # the error is consumed: the writer goes on
    w.save(ok, state, 1, 2.0)
    w.close()
    assert ckpt.read_metadata(ok)["epoch"] == 2


def test_save_after_close_raises(tmp_path, state):
    w = ckpt.AsyncCheckpointer()
    w.save(tmp_path / "a.pth", state, 0, 0.0)
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.save(tmp_path / "b.pth", state, 1, 1.0)
    with pytest.raises(RuntimeError, match="closed"):
        w.wait()


def test_queue_is_bounded():
    """Two pending snapshots at most: one epoch's _curr and _best."""
    w = ckpt.AsyncCheckpointer()
    assert w._q.maxsize == 2
    w.close()


def test_close_drains_pending_writes(tmp_path, state):
    files = [tmp_path / f"c{i}.pth" for i in range(4)]
    w = ckpt.AsyncCheckpointer()
    for i, f in enumerate(files):
        w.save(f, state, i, float(i))
    w.close()
    for i, f in enumerate(files):
        assert ckpt.read_metadata(f)["epoch"] == i + 1


def test_atomic_write_leaves_no_tmp(tmp_path, state, monkeypatch):
    f = tmp_path / "m_curr.pth"
    ckpt.save_checkpoint(f, state, 0, 0.5)
    ckpt.save_checkpoint(f, state, 1, 0.75)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m_curr.pth"]
    good = f.read_bytes()

    def torn(obj, fh):
        fh.write(b"PK\x03\x04 half a file")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(f, state, 2, 1.0)
    assert f.read_bytes() == good  # the old _curr survives a torn write


def test_load_checkpoint_contract(tmp_path, state):
    f = tmp_path / "c.pth"
    ckpt.save_checkpoint(f, state, 3, 0.5, extra={"k": 1})
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(tmp_path / "missing.pth", state)
    wide = engine.build_model(NameSpace({"model": {"variant": "tiny"}}), 6,
                              dtype=torch.float32, device="cpu")
    with pytest.raises(ckpt.CheckpointShapeError, match="logits.weight"):
        ckpt.load_checkpoint(f, wide)
    again = engine.create_state(
        engine.build_model(NameSpace({"model": {"variant": "tiny"}}), 4,
                           dtype=torch.float32, device="cpu"),
        engine.build_optimizer(NameSpace({"type": "adam", "lr": 1e-3,
                                          "ema": 0.5,
                                          "accumulate_steps": 2}), 1))
    _, epoch, best, extra = ckpt.load_checkpoint(f, again, return_extra=True)
    assert (epoch, best, extra) == (4, 0.5, {"k": 1})
    assert (again.step, again.updates, again.mini_step) == (3, 1, 1)
    for a, b in zip(again.ema + again.acc_grads, state.ema + state.acc_grads):
        assert torch.equal(a, b)
    assert ckpt.load_checkpoint(f, again, restore_opt=False)[2] == 0.0
    assert ckpt.load_weights_any_format(f, again.model) == (4, 0.5)
    assert ckpt.read_metadata(f) == {"epoch": 4, "step": 3,
                                     "best_score": 0.5, "extra": {"k": 1}}
    native = tmp_path / "native.pth"
    native.write_bytes(b"\x87\xa5epoch\x01")  # a msgpack map
    with pytest.raises(ValueError, match="Queue 1 item 7"):
        ckpt.load_weights_any_format(native, again.model)


def test_native_batch_reader_matches_jax(tmp_path):
    from PIL import Image

    from openset_imagenet_tpu import transforms as jT
    from openset_imagenet_tpu.native import jpeg as jnj
    from openset_imagenet_tpu_torch import transforms as pT
    from openset_imagenet_tpu_torch.native import jpeg as pnj

    if not (jnj.native_available() and pnj.native_available()):
        pytest.skip("osijpeg could not be built (no g++ or libjpeg)")
    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate([(500, 375), (375, 500), (300, 300),
                                (640, 480)] * 2):
        small = rng.integers(0, 256, (24, 32, 3), np.uint8)
        p = tmp_path / f"img_{i}.JPEG"
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
            p, "JPEG", quality=90)
        paths.append(str(p))
    for crop, resize in ((224, 256), (64, 73)):
        got_reader = pnj.NativeBatchReader(crop=crop, resize=resize,
                                           threads=2)
        ref_reader = jnj.NativeBatchReader(crop=crop, resize=resize,
                                           threads=2)
        for seed in (None, 3):
            rngs = ([None] * len(paths) if seed is None else
                    [pT.sample_rng(seed, 1, i) for i in range(len(paths))])
            refs = ([None] * len(paths) if seed is None else
                    [jT.sample_rng(seed, 1, i) for i in range(len(paths))])
            got = got_reader.read_batch(paths, rngs)
            ref = ref_reader.read_batch(paths, refs)
            assert got.shape == (len(paths), crop, crop, 3)
            np.testing.assert_array_equal(got, ref)
        one = pnj.NativeReader(crop=crop, resize=resize)
        ref_one = jnj.NativeReader(crop=crop, resize=resize)
        np.testing.assert_array_equal(
            one(paths[1], pT.sample_rng(5, 0, 1)),
            ref_one(paths[1], jT.sample_rng(5, 0, 1)))
    # A batch reader through the pipeline: one future a batch, the
    # padding last, the same batches as the per-image native reader.
    labels = np.arange(len(paths)) % 3
    batch = ppipeline.InputPipeline(paths, labels, 5, True, seed=2,
                                    num_workers=2, reader=got_reader)
    single = ppipeline.InputPipeline(paths, labels, 5, True, seed=2,
                                     num_workers=2, reader=pnj.NativeReader(
                                         crop=64, resize=73))
    a, b = list(batch.epoch(0)), list(single.epoch(0))
    assert [x.mask.tolist() for x in a] == [[1.0] * 5, [1.0] * 3 + [0.0] * 2]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.labels, y.labels)
        assert x.images.shape == y.images.shape
    batch.close()
    single.close()

