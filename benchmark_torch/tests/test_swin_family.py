"""The Swin family (``lib/family_swin.py``) through the harness, and the
readers of its cell, on the CPU.

``swin_b-p1`` passes ``families.of`` with the whole contract; the train
generator runs a tiny Swin configuration (``family: swin``) of the
program in float32 to ``correct`` true, and with one weight of the
program perturbed to ``correct`` false; the four new readers read a
stand-in trace and span snapshot as a card would give them, and give
None where nothing ran.

    python -m pytest benchmark_torch/tests -q
"""

import dataclasses
import json
import sys
import types

import pytest
import torch

from conftest import ROOT, traffic
from test_program_spans import _as_on_a_card

from benchmark_torch import run as bench
from benchmark_torch.lib import compare, drive_train, families, harness
from openset_imagenet_tpu_torch import tracing

CELL = "train.swin_b.b256"
NEW = ("train.attention_ms", "train.attention_roofline",
       "train.layernorm_ms", "train.attention_fwd_ms")


def _config(name="swin_b-p1"):
    with open(ROOT / "benchmark_torch" / "configs" / f"{name}.json") as f:
        return json.load(f)


TINY_SWIN = dict(_config(), name="tiny_swin-test", variant="tiny_swin",
                 image_size=32, embed_dim=32, depths=[2, 2],
                 num_heads=[2, 4], window_size=4, fc_layer_dim=6,
                 n_classes=6, batch=16)


def test_swin_b_configuration_takes_the_whole_contract():
    cfg = _config()
    fam = families.of(cfg)
    assert fam.__name__.endswith("family_swin")
    for name in families.CONTRACT:
        assert getattr(fam, name) is not None, name
    names = fam.param_names(cfg)
    assert len(names) == len(set(names)) == 330
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace

    model = engine.build_model(NameSpace({"model": fam.model_options(cfg)}),
                               cfg["n_classes"], device="meta")
    assert [n for n, _ in model.named_parameters()] == names
    assert fam.train_flops(cfg) == 3 * fam.forward_flops(cfg)
    assert fam.model_options(cfg) == {"arch": "swin", "variant": "swin_b"}
    assert fam.control_quant == "fp8"


@pytest.fixture
def float32_program(monkeypatch):
    """The program's ``build_model`` building in float32 (the witness
    that the reference computes what the program does), with ``perturb``
    added to one bias after every strict load."""
    from openset_imagenet_tpu_torch import train as engine

    build = engine.build_model
    state = {"perturb": 0.0}

    def build32(*a, **k):
        model = build(*a, **{**k, "dtype": torch.float32})

        def nudge(module, keys):
            with torch.no_grad():
                module.fc.bias[0] += state["perturb"]

        model.register_load_state_dict_post_hook(nudge)
        return model

    monkeypatch.setattr(engine, "build_model", build32)
    return state


def _run(make_ctx):
    ctx = make_ctx(traffic("train_b256", warm_steps=4, max_imgs_per_s=100000),
                   seed=3100000013, seconds=0.2, config=TINY_SWIN)
    return ctx, drive_train.run(ctx)


def test_tiny_swin_runs_correct_through_the_generator(make_ctx,
                                                      float32_program):
    ctx, res = _run(make_ctx)
    correct, checks = compare.judge(res.numbers, harness.limits_of(ctx))
    assert correct, checks
    assert res.numbers["logits_diff"] < 1e-5
    assert res.numbers["grad_gap"] < 1e-4
    assert res.numbers["feed_errors"] == 0


def test_one_perturbed_weight_is_not_correct(make_ctx, float32_program):
    float32_program["perturb"] = 1.0
    ctx, res = _run(make_ctx)
    assert not compare.judge(res.numbers, harness.limits_of(ctx))[0], \
        res.numbers


SDPA = {"fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
        "AttentionKernel<cutlass::bfloat16_t>::Params)": [0.006, 72],
        "fmha_cutlassB_bf16_aligned_64x64_k64_sm80(PyTorchMemEffAttention::"
        "AttentionBackwardKernel<cutlass::bfloat16_t>::Params)": [0.012, 72]}
LN = {"void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
      "<c10::BFloat16, float>": [0.003, 147],
      "void at::native::(anonymous namespace)::layer_norm_grad_input_kernel"
      "<c10::BFloat16, float>": [0.004, 147],
      "void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel"
      "<c10::BFloat16, float>": [0.002, 147]}
OTHER = {"nvjet_tst_128x256_64x4_2x1_v_bz_TNT": [0.05, 300],
         "void at::native::vectorized_elementwise_kernel": [0.02, 900]}


def _result(kind="train", by_kernel=None, config=None):
    profile = None if by_kernel is None else {
        "window_s": 1.0, "busy_s": 0.9, "steps": 3, "by_kernel": by_kernel,
        "by_cat": {}, "idle_by_span": {}}
    return types.SimpleNamespace(kind=kind, profile=profile,
                                 config=config or _config(),
                                 counters={"batch": 256})


def test_kernel_readers_sum_their_kernels_a_step():
    res = _result(by_kernel={**SDPA, **LN, **OTHER})
    assert bench.read_metric("train.attention_ms", res) == pytest.approx(6.0)
    assert bench.read_metric("train.layernorm_ms", res) == pytest.approx(3.0)
    flops = 3.5 * families.of(res.config).attention_flops(res.config) * 256
    assert bench.read_metric("train.attention_roofline", res) == \
        pytest.approx(100.0 * flops / 989e12 / 6e-3)


@pytest.mark.parametrize("name", NEW[:3])
def test_kernel_readers_are_silent_where_nothing_ran(name):
    assert bench.read_metric(name, _result(by_kernel=OTHER)) is None
    assert bench.read_metric(name, _result(by_kernel=None)) is None
    assert bench.read_metric(name, _result("predict", {**SDPA, **LN})) is None


def test_attention_roofline_needs_a_family_that_counts_attention():
    with open(ROOT / "benchmark_torch" / "configs" / "resnet50-p1.json") as f:
        resnet = json.load(f)
    res = _result(by_kernel={**SDPA, **LN}, config=resnet)
    assert bench.read_metric("train.attention_roofline", res) is None


def _span(name, key, device_ms, parent="train.forward"):
    return tracing.Record(name, 0.0, 1e-3, parent, key, "MainThread",
                          device_ms)


def test_attention_span_reader(monkeypatch):
    records = [_span("swin.attention", k, ms) for k in (8, 9) for ms in
               (1.0, 2.0, 3.0)] + [_span("train.forward", 8, 50.0, None)]
    monkeypatch.setattr(tracing, "snapshot", lambda: records)
    res = _result()
    assert bench.read_metric("train.attention_fwd_ms", res) == \
        pytest.approx(6.0)
    monkeypatch.setattr(tracing, "snapshot", lambda: records[-1:])
    assert bench.read_metric("train.attention_fwd_ms", res) is None
    assert bench.read_metric("train.attention_fwd_ms",
                             _result("predict")) is None


def test_attention_span_reader_of_a_program_without_the_recorder(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "openset_imagenet_tpu_torch.tracing",
                        None)
    assert bench.read_metric("train.attention_fwd_ms", _result()) is None


def test_the_cells_line_carries_its_readers(make_ctx, float32_program,
                                           monkeypatch):
    """A traced tiny-Swin run with the device spans timed as on a card and
    a stand-in trace: the cell's line holds the four new readers and the
    shared ones appended for it, and neither of the ResNet-only two."""
    tracing.clear()
    ctx = make_ctx(traffic("train_b256", warm_steps=4, max_imgs_per_s=100000),
                   seed=5, seconds=0.2, trace=True, config=TINY_SWIN)
    res = drive_train.run(ctx)
    records = [r._replace(device_ms=0.5) if r.name == "swin.attention"
               else r for r in _as_on_a_card(tracing.snapshot())]
    tracing.clear()
    assert {r.name for r in records} >= {"swin.attention", "train.forward"}
    monkeypatch.setattr(tracing, "snapshot", lambda: records)
    res = dataclasses.replace(res, profile=_result(
        by_kernel={**SDPA, **LN, **OTHER}).profile)
    with open(ROOT / "BENCHMARK.json") as f:
        b = json.load(f)
    line = bench.result_line(b, {"name": CELL}, res, True,
                             {"platform": "gpu"}, {}, True)
    got = set(line["metrics"])
    assert set(NEW) <= got
    assert not {"train.conv_roofline", "train.norm_ms"} & got
    assert got <= {m["name"] for m in b["per_layer"]
                   if CELL in m.get("workloads", [])}
    json.dumps(line, allow_nan=False)
