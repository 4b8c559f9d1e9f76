"""Forward (``inference.OpenSetPredictor``, ``train.make_forward_step``):
host milliseconds a traced chunk of ``predict_stream``'s producer in its
``predict.load`` and ``predict.stage`` spans (``openset_imagenet_tpu_torch/
tracing.py``): reading the chunk's images and staging them in a pinned
buffer, the work that must fit inside a forward."""


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
    loaded = {r.key for r in records if r.name == "predict.load"}
    per_chunk = dict.fromkeys(loaded, 0.0)
    for r in records:
        if r.name in ("predict.load", "predict.stage") and r.key in loaded:
            per_chunk[r.key] += 1e3 * (r.t1 - r.t0)
    return sum(per_chunk.values()) / len(per_chunk) if per_chunk else None
