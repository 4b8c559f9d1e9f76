"""Device: share of the traced window in which no operation ran on the
card (the union of the profiler's device events against the window)."""


def read(result):
    p = result.profile
    if result.kind != "predict" or p is None or p["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - p["busy_s"] / p["window_s"])
