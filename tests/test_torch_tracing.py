"""The port's span recorder (``openset_imagenet_tpu_torch/tracing.py``) and
the spans of ``train_epoch``, the input pipeline and ``predict_stream``.

The recorder is on only while a ``torch.profiler`` records; these tests
turn it on with a CPU-only profiler, the way the benchmark's traced
stretches and the worker's ``profile.{dir, epochs}`` do on the card.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openset_imagenet_tpu_torch import tracing
from openset_imagenet_tpu_torch import train as engine
from openset_imagenet_tpu_torch.checkpoint import save_checkpoint
from openset_imagenet_tpu_torch.config import NameSpace
from openset_imagenet_tpu_torch.inference import OpenSetPredictor
from openset_imagenet_tpu_torch.ops.losses import AverageMeter
from openset_imagenet_tpu_torch.pipeline import InputPipeline, SyntheticReader

SIZE, CLASSES, BATCH = 32, 5, 4
PHASES = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


def _profiled(on: bool):
    if not on:
        return tracing.OFF
    return profile(activities=[ProfilerActivity.CPU])


def _model():
    return engine.build_model(
        NameSpace({"model": {"variant": "tiny", "bn_stats_rows": 0}}),
        CLASSES, dtype=torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(3))


def _train(on: bool, steps: int = 2) -> list:
    """``steps`` steps of ``train_epoch`` over a fresh tiny state; the loss
    of every step, as the step returned it."""
    state = engine.create_state(_model(), engine.build_optimizer(
        NameSpace({"type": "adam", "lr": 1e-3}), steps_per_epoch=steps))
    pipe = InputPipeline([str(i) for i in range(steps * BATCH)],
                         np.arange(steps * BATCH) % CLASSES, BATCH,
                         is_training=True, seed=5, num_workers=2,
                         reader=SyntheticReader(crop=SIZE))
    step = engine.make_train_step(engine.make_loss_fn("entropic"))
    losses = []

    def keep(st, images, labels, mask):
        st, m = step(st, images, labels, mask)
        losses.append(m["loss_sum"].clone())
        return st, m

    trackers = {"j": AverageMeter(), "imgs/s": AverageMeter()}
    try:
        with _profiled(on):
            engine.train_epoch(state, pipe, 0, keep, trackers)
    finally:
        pipe.close()
    return losses


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("tracing") / "tiny.pth"
    save_checkpoint(path, _model(), epoch=0, best_score=0.0,
                    extra={"arch": {"variant": "tiny"}})
    return path


def _predict(checkpoint, on: bool, chunks: int = 3) -> list:
    pred = OpenSetPredictor(checkpoint, device="cpu", image_size=SIZE,
                            reader=SyntheticReader(crop=SIZE, seed=1))
    paths = [f"img{i}" for i in range(chunks * BATCH - 1)]
    with _profiled(on):
        return list(pred.predict_stream(paths, batch_size=BATCH, prefetch=1,
                                        return_arrays=True))


def _by_name(records) -> dict:
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_records_nothing_and_returns_the_shared_null_context(
        checkpoint):
    assert tracing.span("train.step", key=0) is tracing.OFF
    assert tracing.span("x", device="cpu") is tracing.OFF
    _train(on=False)
    _predict(checkpoint, on=False)
    assert tracing.snapshot() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.span("x") is not tracing.OFF
    assert tracing.span("x") is tracing.OFF


def test_train_epoch_spans_keys_parents_and_tiling():
    _train(on=True, steps=2)
    spans = _by_name(tracing.snapshot())
    steps = {r.key: r for r in spans["train.step"]}
    assert sorted(steps) == [0, 1]
    # The last wait is the one that finds the epoch's end.
    assert sorted(r.key for r in spans["train.wait"]) == [0, 1, 2]
    for name in PHASES:
        assert sorted(r.key for r in spans[name]) == [0, 1]
        assert {r.parent for r in spans[name]} == {"train.step"}
    for key, step in steps.items():
        assert step.parent is None and step.thread == "MainThread"
        phases = [next(r for r in spans[n] if r.key == key) for n in PHASES]
        edges = [step.t0] + [t for r in phases for t in (r.t0, r.t1)] + [
            step.t1]
        assert edges == sorted(edges)
        wait = next(r for r in spans["train.wait"] if r.key == key)
        assert wait.t1 <= step.t0
    (fetch,) = spans["train.fetch"]
    assert fetch.t0 >= max(r.t1 for r in spans["train.step"])
    assert all(r.device_ms is None and r.device_t0 is None
               for r in tracing.snapshot())


@pytest.mark.parametrize("path", ["pipeline", "predict_stream"])
def test_producer_thread_spans_are_recorded(checkpoint, path):
    """The profiler is started on the main thread; the producers' spans
    are recorded all the same (the recorder reads the process-wide
    flag)."""
    if path == "pipeline":
        _train(on=True, steps=3)
        names, thread, keys = (("pipeline.assemble", "pipeline.put"),
                               "osi-pipeline", [0, 1, 2])
    else:
        _predict(checkpoint, on=True, chunks=3)
        names, thread, keys = (("predict.load", "predict.stage"),
                               "osi-predict-decode", [0, 1, 2])
    spans = _by_name(tracing.snapshot())
    for name in names:
        assert {r.thread for r in spans[name]} == {thread}
        assert sorted(r.key for r in spans[name]) == keys
        assert {r.parent for r in spans[name]} == {None}


def test_predict_stream_consumer_spans(checkpoint):
    _predict(checkpoint, on=True, chunks=3)
    spans = _by_name(tracing.snapshot())
    # The last get finds the producer's end.
    assert sorted(r.key for r in spans["predict.get"]) == [0, 1, 2, 3]
    for name in ("predict.dispatch", "predict.fetch", "predict.post"):
        assert sorted(r.key for r in spans[name]) == [0, 1, 2]
        assert {r.thread for r in spans[name]} == {"MainThread"}
    for k in range(3):
        (dispatch,) = [r for r in spans["predict.dispatch"] if r.key == k]
        (fetch,) = [r for r in spans["predict.fetch"] if r.key == k]
        (post,) = [r for r in spans["predict.post"] if r.key == k]
        assert dispatch.t1 <= fetch.t0 <= fetch.t1 <= post.t0
        assert dispatch.device_ms is None


def test_the_recorder_is_bounded_and_counts_what_it_drops():
    rec = tracing.Recorder(maxlen=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(5):
            with rec.span("s", key=k):
                pass
    assert [r.key for r in rec.snapshot()] == [2, 3, 4]
    assert rec.dropped == 2
    rec.clear()
    assert rec.snapshot() == [] and rec.dropped == 0


def test_children_take_their_parents_key_per_thread():
    rec = tracing.Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("outer", key=7):
            with rec.span("inner", device="cpu"):
                with rec.span("own", key=8):
                    pass
            worker = threading.Thread(
                target=lambda: rec.span("apart").__enter__().__exit__(
                    None, None, None), name="apart-thread")
            worker.start()
            worker.join(timeout=10)
        assert not worker.is_alive()
    got = {r.name: r for r in rec.snapshot()}
    assert (got["inner"].parent, got["inner"].key) == ("outer", 7)
    assert (got["own"].parent, got["own"].key) == ("inner", 8)
    assert (got["apart"].parent, got["apart"].key) == (None, None)
    assert got["apart"].thread == "apart-thread"
    # A CPU device has no events: no device milliseconds.
    assert got["inner"].device_ms is None


def test_spans_are_ranges_of_the_profilers_trace():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("train.step", key=0):
            with tracing.span("train.forward"):
                pass
    names = [e.name for e in prof.events()]
    assert "train.step" in names and "train.forward" in names


def test_a_span_does_not_wait_for_the_interpreter_lock():
    """Beside a thread running Python, a span around nothing stays short:
    entering and leaving it gives the lock away nowhere (a release costs
    up to the 5 ms switch interval before the lock comes back)."""
    rec = tracing.Recorder()
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass

    worker = threading.Thread(target=spin)
    held = []
    with profile(activities=[ProfilerActivity.CPU]):
        worker.start()
        try:
            for _ in range(21):
                t0 = time.perf_counter()
                with rec.span("empty"):
                    pass
                held.append(time.perf_counter() - t0)
        finally:
            stop.set()
            worker.join(timeout=10)
    assert not worker.is_alive() and len(rec.snapshot()) == 21
    held.sort()
    assert held[len(held) // 2] < 1e-3, held


@pytest.mark.parametrize("path", ["train_epoch", "predict_stream"])
def test_results_are_bit_equal_with_the_recorder_on_and_off(checkpoint,
                                                            path):
    if path == "train_epoch":
        off, on = _train(on=False, steps=3), _train(on=True, steps=3)
        assert len(off) == len(on) == 3
        for a, b in zip(off, on):
            assert torch.equal(a, b)
        return
    off = _predict(checkpoint, on=False)
    on = _predict(checkpoint, on=True)
    assert len(off) == len(on) == 3
    for a, b in zip(off, on):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_device_spans_time_the_card():
    """On the card a device span records an event pair on the current
    stream: a sleeping kernel inside reads as device time, the spans of
    one stream follow each other on the device's clock, and the three
    phases of a step tile it there too.  Run on the GPU host with
    ``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``.
    """
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        with tracing.span("first", key=0, device=dev):
            torch.cuda._sleep(10_000_000)
        with tracing.span("second", key=1, device=dev):
            pass
        with tracing.span("host", key=2):
            torch.cuda._sleep(1000)
    got = {r.name: r for r in tracing.snapshot()}
    assert got["first"].device_ms > 0.5
    assert got["first"].device_t0 == 0.0
    assert got["first"].device_t1 <= got["second"].device_t0
    assert got["second"].device_ms >= 0
    assert got["host"].device_ms is None

    tracing.clear()
    model = _model().to(dev)
    state = engine.create_state(model, engine.build_optimizer(
        NameSpace({"type": "adam", "lr": 1e-3}), steps_per_epoch=2))
    pipe = InputPipeline([str(i) for i in range(2 * BATCH)],
                         np.arange(2 * BATCH) % CLASSES, BATCH,
                         is_training=True, num_workers=2, pin_memory=True,
                         reader=SyntheticReader(crop=SIZE))
    step = engine.make_train_step(engine.make_loss_fn("entropic"))
    trackers = {"j": AverageMeter(), "imgs/s": AverageMeter()}
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            engine.train_epoch(state, pipe, 0, step, trackers)
    finally:
        pipe.close()
    spans = _by_name(tracing.snapshot())
    for key in (0, 1):
        phases = [next(r for r in spans[n] if r.key == key) for n in PHASES]
        edges = [t for r in phases for t in (r.device_t0, r.device_t1)]
        assert edges == sorted(edges)
        assert all(r.device_ms > 0 for r in phases)
