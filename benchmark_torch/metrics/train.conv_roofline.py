"""Kernels, the step's products: the least time of every convolution and
dense-head pass of a step (each forward, data gradient and weight
gradient bounded by the larger of its FLOPs at 989 TFLOP/s and its bytes
at 3.35 TB/s) over the device time a step spends in the profiler's
``conv`` and ``gemm`` categories (cuDNN runs many 1x1 convolutions on
GEMM kernels, cuBLASLt's ``nvjet`` and CUTLASS's among them)."""

from benchmark_torch.lib import card, flops


def read(result):
    p = result.profile
    if result.kind != "train" or p is None:
        return None
    cat = p["by_cat"]
    ms = 1e3 * (cat.get("conv", 0.0) + cat.get("gemm", 0.0)) / p["steps"]
    if ms <= 0:
        return None
    bound = flops.product_step_bound_ms(result.config,
                                        int(result.counters["batch"]), card)
    return 100.0 * bound / ms
