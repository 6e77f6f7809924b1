"""The share of the traced window, in %, in which the device was idle
(``Records.gaps()``) while the host was inside one of the program's
outermost spans (``..program_trace``): idle time the program's own host
work left. None where the program records no such spans."""

from .. import program_trace


def read(spec: dict, ctx: dict):
    spans = program_trace.outermost(ctx)
    if spans is None:
        return None
    records = ctx["records"]
    idle = program_trace.idle_inside(records.gaps(), spans)
    return 100.0 * idle / records.window_s
