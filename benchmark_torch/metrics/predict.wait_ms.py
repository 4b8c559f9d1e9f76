"""Forward (``inference.OpenSetPredictor``, ``train.make_forward_step``):
host milliseconds a traced chunk that ``predict_stream``'s consumer
waited for the producer (the program's ``predict.get`` span,
``openset_imagenet_tpu_torch/tracing.py``)."""


def read(result):
    if result.kind != "predict":
        return None
    try:
        from openset_imagenet_tpu_torch import tracing
    except ImportError:  # a program without the span recorder
        return None
    records = tracing.snapshot()
    # A figure of a run on a card: without one (no span carries device
    # time) the forward runs on the host's cores beside the producer.
    if not any(r.device_ms is not None for r in records):
        return None
    per_chunk = {}
    for r in records:
        if r.name == "predict.get":
            per_chunk[r.key] = per_chunk.get(r.key, 0.0) + 1e3 * (r.t1 - r.t0)
    return sum(per_chunk.values()) / len(per_chunk) if per_chunk else None
