"""Model (``models/swin.py``): device milliseconds a traced step between
the two CUDA events of each of the program's ``swin.attention`` spans
(``openset_imagenet_tpu_torch/tracing.py``; one a block in the forward:
roll, window partition, bias and mask, attention with its qkv and
projection, merge, reverse roll), idle time inside included.  None for a
program without the recorder or without the span (a ResNet, or a program
that builds no Swin)."""


def read(result):
    if result.kind != "train":
        return None
    try:
        from openset_imagenet_tpu_torch import tracing
    except ImportError:  # a program without the span recorder
        return None
    per_step = {}
    for r in tracing.snapshot():
        if r.name == "swin.attention" and r.device_ms is not None:
            per_step[r.key] = per_step.get(r.key, 0.0) + r.device_ms
    return sum(per_step.values()) / len(per_step) if per_step else None
