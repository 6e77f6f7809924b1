"""The median host time to enqueue one request, in ms: the benchmark's
own span around the program's calls, with no wait for the device."""

import numpy as np


def read(spec: dict, ctx: dict):
    ms = ctx["driver"].issue_ms()
    return float(np.median(ms)) if len(ms) else None
