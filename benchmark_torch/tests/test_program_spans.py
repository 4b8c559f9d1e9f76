"""CPU rehearsal of the readers of the program's own spans (the port's
``tracing.py``): a tiny traced run of the train and predict traffic, each
reader off a card and with the device spans timed as a card would time
them, and the readers against a program that has no recorder.

    python -m pytest benchmark_torch/tests -q
"""

import dataclasses
import json
import math
import sys

import pytest

from conftest import ROOT, traffic
from test_rehearsal import _fake_summary
from test_rehearsal import test_benchmark_json_follows_its_rules as _rules

from benchmark_torch import run as bench
from benchmark_torch.lib import drive_predict, drive_train
from openset_imagenet_tpu_torch import tracing

TRAIN = {"train.forward_ms": "device", "train.backward_ms": "device",
         "train.optimizer_ms": "device", "train.dispatch_ms": "host",
         "train.wait_ms": "host"}
PREDICT = {"predict.forward_ms": "device", "predict.gap_ms": "device",
           "predict.wait_ms": "host", "predict.load_ms": "host"}
CELLS = {"train": ["train.resnet50.b256", "train.wide_resnet50_2.b256"],
         "predict": ["predict.resnet50.b256"]}
DEVICE_SPANS = ("train.forward", "train.backward", "train.optimizer",
                "predict.dispatch")


def _traced(kind, make_ctx):
    tracing.clear()
    if kind == "train":
        ctx = make_ctx(traffic("train_b256", warm_steps=4,
                               max_imgs_per_s=100000), trace=True)
        return drive_train.run(ctx), TRAIN
    ctx = make_ctx(traffic("predict_b256", batch=16, distinct_images=64,
                           check_rows=32, calibration_images=8,
                           max_imgs_per_s=100000), trace=True)
    return drive_predict.run(ctx), PREDICT


def _as_on_a_card(records):
    """The records with each device span's events put at its host ends,
    as the card's clock would read a span that waits for its work."""
    base = min(r.t0 for r in records)
    return [r._replace(device_ms=1e3 * (r.t1 - r.t0),
                       device_t0=1e3 * (r.t0 - base),
                       device_t1=1e3 * (r.t1 - base))
            if r.name in DEVICE_SPANS else r for r in records]


@pytest.fixture(params=["train", "predict"])
def traced(request, make_ctx):
    res, readers = _traced(request.param, make_ctx)
    yield res, readers
    tracing.clear()


@pytest.fixture
def predicted(make_ctx):
    res, _ = _traced("predict", make_ctx)
    yield res
    tracing.clear()


def test_readers_of_a_traced_run(traced, monkeypatch):
    res, readers = traced
    records = tracing.snapshot()
    names = {r.name for r in records}
    # The traced stretch's steps or chunks, and only those.
    assert len({r.key for r in records if r.name in (
        "train.step", "predict.dispatch")}) == 3
    assert names >= {"train": {"train.wait", "train.step", *DEVICE_SPANS[:3],
                               "pipeline.assemble", "pipeline.put"},
                     "predict": {"predict.get", "predict.dispatch",
                                 "predict.load", "predict.stage",
                                 "predict.fetch", "predict.post"}}[res.kind]
    # Off a card: no device time, and no host figure either.
    for name in readers:
        assert bench.read_metric(name, res) is None, name
    # On a card: every reader finite, and none for the other kind.
    monkeypatch.setattr(tracing, "snapshot",
                        lambda: _as_on_a_card(records))
    for name in readers:
        value = bench.read_metric(name, res)
        assert value is not None and math.isfinite(value), name
        assert value >= 0, name
    other = dataclasses.replace(res, kind={"train": "predict",
                                           "predict": "train"}[res.kind])
    for name in readers:
        assert bench.read_metric(name, other) is None, name


def test_the_result_line_carries_the_readers_of_its_cell(traced,
                                                         monkeypatch):
    res, readers = traced
    records = _as_on_a_card(tracing.snapshot())
    monkeypatch.setattr(tracing, "snapshot", lambda: records)
    # The harness's own reduction of the trace holds no device operation
    # on the CPU: a stand-in, as the rehearsal of the harness uses.
    res = dataclasses.replace(res, profile=_fake_summary(3))
    with open(ROOT / "BENCHMARK.json") as f:
        b = json.load(f)
    for cell in CELLS[res.kind]:
        line = bench.result_line(b, {"name": cell}, res, True,
                                 {"platform": "gpu"}, {}, True)
        assert set(readers) <= set(line["metrics"]), cell
        json.dumps(line, allow_nan=False)


def test_the_gap_reader_spans_one_dispatch_to_the_next(predicted,
                                                       monkeypatch):
    res = predicted
    records = _as_on_a_card(tracing.snapshot())
    monkeypatch.setattr(tracing, "snapshot", lambda: records)
    d = sorted((r for r in records if r.name == "predict.dispatch"),
               key=lambda r: r.key)
    gaps = [1e3 * (b.t0 - a.t1) for a, b in zip(d, d[1:])
            if b.key == a.key + 1]
    assert bench.read_metric("predict.gap_ms", res) == pytest.approx(
        sum(gaps) / len(gaps))


@pytest.mark.parametrize("name", sorted({**TRAIN, **PREDICT}))
def test_readers_of_a_program_without_the_recorder(name, monkeypatch):
    """A program older than the recorder: the import fails, the reader
    gives nothing and raises nothing."""
    monkeypatch.setitem(sys.modules, "openset_imagenet_tpu_torch.tracing",
                        None)
    res = type("R", (), {"kind": name.split(".")[0]})()
    assert bench.read_metric(name, res) is None


def test_the_nine_entries_follow_the_benchmarks_rules():
    _rules()
    with open(ROOT / "BENCHMARK.json") as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name, source in {**TRAIN, **PREDICT}.items():
        m = per_layer[name]
        kind = name.split(".")[0]
        assert m["workloads"] == CELLS[kind], name
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert m["source"] == {"device": "device_trace",
                               "host": "host_clock"}[source]
        assert m["moves"] == f"{kind}_gpu_us_per_img"
        assert (ROOT / "benchmark_torch" / "metrics" / f"{name}.py").exists()
