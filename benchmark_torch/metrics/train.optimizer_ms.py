"""Train step (``train.make_train_step``): device milliseconds a traced
step between the two CUDA events of the program's ``train.optimizer``
span (``openset_imagenet_tpu_torch/tracing.py``): ``apply_gradients``,
Adam over every leaf, idle time inside included."""


def read(result):
    if result.kind != "train":
        return None
    try:
        from openset_imagenet_tpu_torch import tracing
    except ImportError:  # a program without the span recorder
        return None
    per_step = {}
    for r in tracing.snapshot():
        if r.name == "train.optimizer" and r.device_ms is not None:
            per_step[r.key] = per_step.get(r.key, 0.0) + r.device_ms
    return sum(per_step.values()) / len(per_step) if per_step else None
