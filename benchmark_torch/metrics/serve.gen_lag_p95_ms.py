"""Load generator (the benchmark's client process): 95th percentile of how
late a request of the window woke against when it was due."""

import math


def read(result):
    if result.kind != "serve":
        return None
    lag = result.counters["gen_lag_p95_ms"]
    return lag if math.isfinite(lag) else None
