"""CPU rehearsal of the benchmark: the operation counter against the
published figures, the reference against the program in float32, every
traffic generator end to end at a tiny size, the span recorder, the trace
reduction, the metric readers and the result line, and the refusal to
measure without a card.

    python -m pytest benchmark_torch/tests -q
"""

import json
import math
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY, traffic

from benchmark_torch import run as bench
from benchmark_torch.lib import (compare, drive_predict, drive_serve,
                                 drive_train, families, flops, profile,
                                 reference)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("variant,base_width,gmacs", [
    ("resnet50", 64, 4.09), ("wide_resnet50_2", 128, 11.4)])
def test_forward_macs_match_published(variant, base_width, gmacs):
    """torchvision's published 4.09 / 11.4 GMACs at 224 px (its 1000-way
    head; the counter's convolutions plus that head)."""
    cfg = {"image_size": 224, "stage_sizes": [3, 4, 6, 3],
           "base_width": base_width, "fc_layer_dim": 1000,
           "n_classes": 0}
    macs = flops.forward_macs(cfg)
    assert abs(macs / 1e9 - gmacs) / gmacs < 0.005, macs


def test_config_files_match_the_counter_and_reference():
    for c in _bench()["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        family = families.of(cfg)
        names = family.param_names(cfg)
        assert len(names) == len(set(names))
        assert family.train_flops(cfg) == 3 * family.forward_flops(cfg)


def test_benchmark_json_follows_its_rules():
    b = _bench()
    assert b["command"] == ["python3", "benchmark_torch/run.py"]
    assert b["paths"] == ["benchmark_torch"]
    configs = {c["name"] for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "benchmark_torch" / "metrics"
                / f"{m['name']}.py").exists()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "benchmark_torch" / "traffic"
                / f"{w['traffic']}.json").exists()
        reported = [m for m in b["end_to_end"] if m["name"] != "setup_s"
                    and w["name"] in m.get("workloads", [w["name"]])]
        assert reported
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in b["per_layer"])


def test_blocked_gradients_equal_one_block():
    cfg = dict(TINY)
    w = reference.make_weights(cfg, 3, "cpu")
    params = {n: w[n].clone().requires_grad_()
              for n in reference.param_names(cfg)}
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(-1, 6, 16)
    one = reference.loss_and_grads(params, images, labels, cfg, 8, 16)
    blocks = reference.loss_and_grads(params, images, labels, cfg, 8, 3)
    assert abs(float(one[0]) - float(blocks[0])) < 1e-5
    for n in params:
        torch.testing.assert_close(one[1][n], blocks[1][n], rtol=1e-4,
                                   atol=1e-5)


def test_program_in_float32_matches_the_reference(make_ctx, monkeypatch):
    """The witness that the reference computes what the program does: the
    train traffic with the model built in float32 agrees to round-off."""
    from openset_imagenet_tpu_torch import train as engine

    build = engine.build_model
    monkeypatch.setattr(engine, "build_model", lambda *a, **k: build(
        *a, dtype=torch.float32, **k))
    ctx = make_ctx(traffic("train_b256", warm_steps=4,
                           max_imgs_per_s=100000), seed=2, seconds=0.2)
    res = drive_train.run(ctx)
    assert res.numbers["loss_gap"] < 1e-5
    assert res.numbers["grad_gap"] < 1e-4
    assert res.numbers["logits_diff"] < 1e-4
    assert res.numbers["feed_errors"] == 0


# The serve cell's entries, for a benchmark that runs the serve traffic
# (no cell of BENCHMARK.json does yet: PERF.md, Open questions).
SERVE = {"name": "serve.resnet50.open",
         "e2e": {"name": "serve_p95_ms", "unit": "ms"},
         "per_layer": [{"name": n, "unit": u} for n, u in (
             ("serve.mean_batch", "imgs"), ("serve.gen_lag_p95_ms", "ms"),
             ("serve.idle_share", "%"))]}


def _check_line(ctx, res, trace):
    b = _bench()
    if res.kind == "serve":
        b["end_to_end"] = [SERVE["e2e"], {"name": "setup_s", "unit": "s"}]
        b["per_layer"] = SERVE["per_layer"]
    kind = {"train": "train.resnet50.b256",
            "predict": "predict.resnet50.b256",
            "serve": SERVE["name"]}[res.kind]
    cell = {"name": kind}
    if trace:
        res.profile = _fake_summary(res.counters.get("batch", 1))
    ok, checks = compare.judge(res.numbers, {k: 1e9 for k in res.numbers})
    line = bench.result_line(b, cell, res, trace, {"platform": "gpu"},
                             checks, ok)
    assert list(line)[-1] == "checks"
    json.dumps(line, allow_nan=False)
    for m in line["metrics"].values():
        assert math.isfinite(m["value"])
    return line


def _fake_summary(steps):
    return {"window_s": 1.0, "busy_s": 0.8, "steps": 3,
            "by_kernel": {"void at::native::vectorized_elementwise": [0.3, 9],
                          "sm90_xmma_fprop_implicit_gemm": [0.4, 3],
                          "entropic_fwd_once": [1e-5, 3]},
            "by_cat": {"elementwise": 0.3, "conv": 0.4,
                       "loss (Triton)": 1e-5},
            "idle_by_span": {"pipeline.next": 0.1, "none": 0.1}}


def test_train_rehearsal(make_ctx):
    ctx = make_ctx(traffic("train_b256", warm_steps=4,
                           max_imgs_per_s=100000), trace=True)
    res = drive_train.run(ctx)
    assert res.e2e == {"setup_s": res.e2e["setup_s"]} and \
        res.e2e["setup_s"] > 0
    assert res.counters["window_steps"] > 0
    assert res.numbers["feed_errors"] == 0
    assert set(res.numbers) == {"loss_gap", "loss1_gap", "grad_gap",
                                "logits_diff", "change_gap", "feed_errors"}
    assert "pipeline.next" in res.spans.names()
    # Off the card the window has no device time: setup_s alone.
    line = _check_line(ctx, res, trace=False)
    assert set(line["metrics"]) == {"setup_s"}
    line = _check_line(ctx, res, trace=True)
    assert {"train.data_wait_ms", "train.mfu", "train.elementwise_ms",
            "train.conv_roofline", "train.loss_roofline",
            "train.idle_share", "train.imgs_per_s"} == set(line["metrics"])
    c = res.counters
    assert line["metrics"]["train.imgs_per_s"]["value"] == pytest.approx(
        c["window_images"] / c["window_s"])
    assert line["breakdown"]["idle_gaps"][0][0] == "pipeline.next"


def test_predict_rehearsal(make_ctx):
    ctx = make_ctx(traffic("predict_b256", batch=16, distinct_images=64,
                           check_rows=32, calibration_images=8,
                           max_imgs_per_s=100000), trace=True)
    res = drive_predict.run(ctx)
    assert set(res.e2e) == {"setup_s"} and res.counters["window_images"] > 0
    assert res.numbers["missing"] == 0 and res.failed == 0
    line = _check_line(ctx, res, trace=True)
    assert {"predict.mfu", "predict.elementwise_ms",
            "predict.idle_share", "predict.imgs_per_s"} == set(line["metrics"])


def test_serve_rehearsal(make_ctx):
    ctx = make_ctx(traffic("serve_open", rate=40.0, max_batch=8,
                           connections=8, distinct_images=64, check_rows=16,
                           calibration_images=8, trace_seconds=0.3),
                   seconds=1.0, trace=True)
    res = drive_serve.run(ctx)
    assert res.attempted == 40 and res.failed == 0
    assert 0 < res.e2e["serve_p95_ms"] < 60e3
    assert res.counters["stats_batches"] > 0
    line = _check_line(ctx, res, trace=True)
    assert {"serve.mean_batch", "serve.gen_lag_p95_ms",
            "serve.idle_share"} == set(line["metrics"])


class _FakeWindow:
    """The profiler of a window on the card, as the generators drive it:
    started once at the window's start, stopped once at its close."""

    made = []

    def __init__(self, device):
        self.calls = []
        _FakeWindow.made.append(self)

    def start(self):
        self.calls.append("start")
        return self

    def stop(self):
        self.calls.append("stop")

    def busy_s(self):
        self.calls.append("busy_s")
        return 0.25


@pytest.mark.parametrize("kind", ["train", "predict"])
def test_window_device_time_per_image(make_ctx, monkeypatch, kind):
    """On a card a ``--trace 0`` run profiles its window alone, and the
    end-to-end metric is the busy time over the window's images."""
    monkeypatch.setattr(profile, "on_card", lambda device: True)
    monkeypatch.setattr(profile, "Trace", _FakeWindow)
    monkeypatch.setattr(_FakeWindow, "made", [])
    if kind == "train":
        ctx = make_ctx(traffic("train_b256", warm_steps=4,
                               max_imgs_per_s=100000), seconds=0.2)
        res = drive_train.run(ctx)
    else:
        ctx = make_ctx(traffic("predict_b256", batch=16, distinct_images=64,
                               check_rows=32, calibration_images=8,
                               max_imgs_per_s=100000))
        res = drive_predict.run(ctx)
    assert [w.calls for w in _FakeWindow.made] == [["start", "stop",
                                                    "busy_s"]]
    name = f"{kind}_gpu_us_per_img"
    assert res.e2e[name] == pytest.approx(
        1e6 * 0.25 / res.counters["window_images"])
    line = _check_line(ctx, res, trace=False)
    assert set(line["metrics"]) == {name, "setup_s"}


def test_trace_reduction():
    cuda = torch.autograd.DeviceType.CUDA

    def evt(name, s, e, annotation=False):
        return types.SimpleNamespace(
            name=name, device_type=cuda, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(start=s, end=e))

    # The marker kernel at 1000 us on the trace's clock, launched at host
    # second 5.0: host spans move by 1000 - 5e6 us.
    events = [evt("spin_kernel", 1000, 1001),
              evt("vectorized_elementwise_kernel", 1010, 1030),
              evt("sm90_xmma_fprop", 1025, 1050),
              evt("nvjet_tst_64x512", 1080, 1100),
              evt("train_step", 1000, 1040, annotation=True)]
    host = [("train_step", 5.0, 5.000040), ("pipeline.next", 5.000040,
                                            5.000070)]
    s = profile.summarize(events, host, 2, 5.0)
    assert s["busy_s"] == pytest.approx(60e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["by_cat"]["conv"] == pytest.approx(25e-6)
    assert s["by_cat"]["gemm"] == pytest.approx(20e-6)
    assert "train_step" not in s["by_kernel"]
    assert s["idle_by_span"] == pytest.approx(
        {"train_step": 10e-6, "pipeline.next": 30e-6})
    b = profile.breakdown(s)
    assert b["device_ops"][0][0] == "sm90_xmma_fprop"
    assert profile.summarize(events[:1], host, 1, 5.0) is None


def test_raw_busy_time_equals_the_reduction():
    """The window's busy time from the profiler's raw events is the
    reduction's ``busy_s`` over the same operations."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    base = 1_760_000_000_000_000_000  # ns since the epoch, as kineto's

    class Raw:
        def __init__(self, name, s, e, device=cuda, annotation=False):
            self._n, self._s, self._e = name, base + s, base + e
            self._d, self._a = device, annotation

        def name(self):
            return self._n

        def device_type(self):
            return self._d

        def is_user_annotation(self):
            return self._a

        def start_ns(self):
            return self._s

        def end_ns(self):
            return self._e

    rows = [("spin_kernel", 1000, 1001, cuda, False),
            ("vectorized_elementwise_kernel", 1010, 1030, cuda, False),
            ("sm90_xmma_fprop", 1025, 1050, cuda, False),
            ("nvjet_tst_64x512", 1080, 1100, cuda, False),
            ("train_step", 1000, 1040, cuda, True),
            ("cudaLaunchKernel", 1000, 1100, cpu, False)]
    raw = [Raw(*r) for r in rows]
    evts = [types.SimpleNamespace(
        name=n, device_type=d, is_user_annotation=a,
        time_range=types.SimpleNamespace(start=s / 1e3, end=e / 1e3))
        for n, s, e, d, a in rows]
    want = profile.summarize(evts, (), 0, 0.0)["busy_s"]
    assert profile.device_busy_s(raw) == pytest.approx(want, abs=1e-15)
    assert profile.device_busy_s(raw) == pytest.approx(60e-9)
    assert profile.device_busy_s(raw[:1] + raw[4:]) is None


def test_run_without_a_card_exits_without_a_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark_torch" / "run.py"),
         "--workload", "train.resnet50.b256", "--seed", "3000000000",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        cwd=ROOT, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode == 3
    assert proc.stdout.strip() == ""


def test_jax_check_takes_whole_top_level_names(monkeypatch):
    before = bench.jax_loaded()
    monkeypatch.setitem(sys.modules, "openset_imagenet_tpu_torch.fake",
                        types.ModuleType("openset_imagenet_tpu_torch.fake"))
    assert bench.jax_loaded() == before
    for name in ("flax.core", "jaxlib", "openset_imagenet_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"flax", "jaxlib", "openset_imagenet_tpu"} <= set(
        bench.jax_loaded())
