"""Open-loop arrival schedules, from a traffic file's parameters.

The gaps between arrivals are the quantiles of the mix's gap distribution
at evenly spaced probabilities, scaled so that the period holds exactly
its share of requests, and shuffled by the traffic file's
``schedule_seed``. So every run offers the same arrivals in the same
order, and a run's ``--seed`` changes only the content: runs with other
seeds queued differently enough to move the tails by a fifth (PERF.md).

``arrivals`` is ``"poisson"``: exponential gaps at ``rate_per_s``.
"""

from __future__ import annotations

import numpy as np


def _times(rng, count: int, span: float) -> np.ndarray:
    """``count`` due times in [0, span): exponential gaps at evenly spaced
    quantiles, shuffled, scaled to end just before ``span``."""
    if count <= 0:
        return np.zeros(0)
    u = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-u)
    rng.shuffle(gaps)
    t = np.cumsum(gaps)
    return t * (span * count / (count + 1) / t[-1])


def schedule(traffic: dict, seconds: float) -> np.ndarray:
    """Due times in [0, seconds), ascending, of every request of the
    window."""
    kind = traffic.get("arrivals", "poisson")
    if kind != "poisson":
        raise ValueError(f"unknown arrivals {kind!r}")
    rng = np.random.default_rng(traffic["schedule_seed"])
    count = int(round(float(traffic["rate_per_s"]) * seconds))
    return _times(rng, count, seconds)
