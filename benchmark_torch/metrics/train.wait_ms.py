"""Input pipeline (``pipeline.InputPipeline``): host milliseconds a traced
step that ``train_epoch`` waited in ``next()`` on the pipeline's iterator
(the program's ``train.wait`` span, ``openset_imagenet_tpu_torch/
tracing.py``)."""


def read(result):
    if result.kind != "train":
        return None
    try:
        from openset_imagenet_tpu_torch import tracing
    except ImportError:  # a program without the span recorder
        return None
    records = tracing.snapshot()
    # A figure of a run on a card: without one (no span carries device
    # time) the steps' kernels share the host's cores with the decode.
    if not any(r.device_ms is not None for r in records):
        return None
    per_step = {}
    for r in records:
        if r.name == "train.wait":
            per_step[r.key] = per_step.get(r.key, 0.0) + 1e3 * (r.t1 - r.t0)
    return sum(per_step.values()) / len(per_step) if per_step else None
