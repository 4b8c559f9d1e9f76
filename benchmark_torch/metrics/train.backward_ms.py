"""Model (``models/resnet.py``, ``models/norm.py``): device milliseconds a
traced step between the two CUDA events of the program's ``train.backward``
span (``openset_imagenet_tpu_torch/tracing.py``): ``zero_grad`` and
``loss.backward()``, idle time inside included."""


def read(result):
    if result.kind != "train":
        return None
    try:
        from openset_imagenet_tpu_torch import tracing
    except ImportError:  # a program without the span recorder
        return None
    per_step = {}
    for r in tracing.snapshot():
        if r.name == "train.backward" and r.device_ms is not None:
            per_step[r.key] = per_step.get(r.key, 0.0) + r.device_ms
    return sum(per_step.values()) / len(per_step) if per_step else None
