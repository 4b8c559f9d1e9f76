"""Model (``models/swin.py``): device milliseconds a traced step in the
LayerNorm kernels, forward and backward (``lib/kernel_names.py``'s
``LAYER_NORM``).  None where none ran (a model without LayerNorm)."""

from benchmark_torch.lib import kernel_names


def read(result):
    if result.kind != "train":
        return None
    return kernel_names.step_ms(result.profile, kernel_names.LAYER_NORM)
