"""The readers of the batch-norm kernels' device time,
``train.norm_ms`` and ``predict.norm_ms``: milliseconds a traced step or
chunk in the operations named ``osi_bn_*``, and None for another kind of
run, an untraced run, or a trace in which no such kernel ran (the
written-out batch-norm of an earlier program, or the CPU).

    python -m pytest benchmark_torch/tests -q
"""

import types

import pytest

from benchmark_torch import run as bench

BN_KERNELS = {"osi_bn_stats": [0.003, 159], "osi_bn_apply": [0.012, 159],
              "osi_bn_bwd": [0.018, 159], "osi_bn_fix": [0.006, 159]}
OTHER = {"void at::native::vectorized_elementwise_kernel": [0.02, 900],
         "sm90_xmma_fprop_implicit_gemm": [0.05, 300],
         "entropic_fwd_once": [1e-5, 3]}


def _result(kind, by_kernel, steps=3):
    profile = None if by_kernel is None else {
        "window_s": 1.0, "busy_s": 0.9, "steps": steps,
        "by_kernel": by_kernel, "by_cat": {}, "idle_by_span": {}}
    return types.SimpleNamespace(kind=kind, profile=profile)


@pytest.mark.parametrize("name,kind", [("train.norm_ms", "train"),
                                       ("predict.norm_ms", "predict")])
def test_reader_sums_the_batch_norm_kernels_a_step(name, kind):
    got = bench.read_metric(name, _result(kind, {**BN_KERNELS, **OTHER}))
    assert got == pytest.approx(1e3 * 0.039 / 3)
    only_apply = {"osi_bn_apply": [0.012, 159], **OTHER}
    assert bench.read_metric(name, _result(kind, only_apply)) == \
        pytest.approx(4.0)


@pytest.mark.parametrize("name,kind,other", [
    ("train.norm_ms", "train", "predict"),
    ("predict.norm_ms", "predict", "train")])
def test_reader_is_silent_where_nothing_ran(name, kind, other):
    assert bench.read_metric(name, _result(other, BN_KERNELS)) is None
    assert bench.read_metric(name, _result("serve", BN_KERNELS)) is None
    assert bench.read_metric(name, _result(kind, OTHER)) is None
    assert bench.read_metric(name, _result(kind, None)) is None
