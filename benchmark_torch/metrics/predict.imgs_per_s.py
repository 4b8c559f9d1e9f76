"""Forward (``inference.OpenSetPredictor.predict_stream``): every image
whose result was yielded in the window over its seconds on the host's
clock.  It is the rate a user scoring a test set sees, and it follows the
host's speed while the producer bounds the stream; ``--trace 1`` runs
measure the window without the profiler."""


def read(result):
    if result.kind != "predict":
        return None
    c = result.counters
    return c["window_images"] / c["window_s"]
