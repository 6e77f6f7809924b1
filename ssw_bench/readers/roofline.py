"""A kernel's share of its roofline, in %: the least time of the work of
the traced window (``..roofline``'s count named by ``count``) over the
device time of the trace's records whose names match ``kernels``.

``shared``: records of a kernel that two of the program's kernels launch
alike, on the same indices (the row compaction of K9 and K10); each is
given the ``shared_by``-th part of their time."""

from __future__ import annotations

from .. import roofline


def read(spec: dict, ctx: dict):
    records = ctx["records"]
    busy = sum(e - s for _, s, e in records.matching(spec["kernels"]))
    if busy <= 0:
        return None
    if spec.get("shared"):
        busy += sum(e - s for _, s, e in records.matching(spec["shared"])) \
            / spec["shared_by"]
    flops, peak, nbytes = getattr(roofline, spec["count"])(ctx["cfg"],
                                                           ctx["work"])
    least, _ = roofline.least_seconds(flops, peak, nbytes)
    return 100.0 * least / busy
