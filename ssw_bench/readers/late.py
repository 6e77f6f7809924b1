"""The load generator's 95th percentile lateness, in ms: each request's
send time minus its due time, on the benchmark's own clock."""

import numpy as np


def read(spec: dict, ctx: dict):
    ms = ctx["driver"].late_ms()
    return float(np.percentile(ms, 95)) if len(ms) else None
