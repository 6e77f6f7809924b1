"""A request's wait on the CUDA stream, in ms, at the metric's
``percentile``: for each driver ``issue`` span of the traced window, the
first of the program's outermost spans that opens inside it, the time its
open event reached the stream minus its host open time (``..program_trace``).
None where the program records no such spans."""

import numpy as np

from .. import program_trace


def read(spec: dict, ctx: dict):
    spans = program_trace.outermost(ctx)
    if spans is None:
        return None
    records = ctx["records"]
    issues = [(s, e) for label, s, e in ctx["driver"].spans.items
              if label == "issue" and records.t_start <= s <= records.t_stop]
    waits = program_trace.stream_waits(issues, spans)
    if not waits:
        return None
    return float(np.percentile(np.array(waits) * 1e3, spec["percentile"]))
