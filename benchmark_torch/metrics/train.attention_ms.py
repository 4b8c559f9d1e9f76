"""Model (``models/swin.py``): device milliseconds a traced step in the
scaled-dot-product attention kernels, forward and backward
(``lib/kernel_names.py``'s ``ATTENTION``).  None where none ran (a model
without attention, or a program that builds no Swin)."""

from benchmark_torch.lib import kernel_names


def read(result):
    if result.kind != "train":
        return None
    return kernel_names.step_ms(result.profile, kernel_names.ATTENTION)
