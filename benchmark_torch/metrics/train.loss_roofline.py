"""Kernels K1 + K2 (``ops/triton_fused_loss.py``): the least time of the
entropic loss's two kernels (their bytes at 3.35 TB/s) over their device
time a step (the profiler's ``loss (Triton)`` category)."""

from benchmark_torch.lib import card, flops


def read(result):
    p = result.profile
    if result.kind != "train" or p is None:
        return None
    loss_ms = 1e3 * p["by_cat"].get("loss (Triton)", 0.0) / p["steps"]
    if loss_ms <= 0:
        return None
    nbytes = flops.loss_kernel_bytes(int(result.counters["batch"]),
                                     int(result.config["n_classes"]))
    return 100.0 * card.bound_ms(nbytes)[0] / loss_ms
