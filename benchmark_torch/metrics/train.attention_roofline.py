"""Kernels, attention: the FLOPs of a step's attention products (the
family's ``attention_flops``, QK^T and PV of one image's forward, times
the batch; the backward counted as 2.5 forwards, as FlashAttention counts
it) at 989 TFLOP/s, over the step's device time in the attention kernels
(``train.attention_ms``), as a share.  None where none ran or the family
counts no attention."""

from benchmark_torch.lib import card, families, kernel_names


def read(result):
    if result.kind != "train":
        return None
    ms = kernel_names.step_ms(result.profile, kernel_names.ATTENTION)
    count = getattr(families.of(result.config), "attention_flops", None)
    if ms is None or count is None:
        return None
    flops = 3.5 * count(result.config) * int(result.counters["batch"])
    return 100.0 * card.bound_ms(0.0, flops)[0] / ms
