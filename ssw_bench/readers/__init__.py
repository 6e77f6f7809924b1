"""Per-layer metric readers, one module each, named by a metric file's
``reader`` key. ``read(spec, ctx)`` returns the metric's value, or None
where the window gave it nothing to read (the metric is then left out).

``ctx`` holds ``cfg`` and ``traffic`` (the cell's files), ``driver`` (its
host clock's spans and per-request times), ``records`` (the device trace,
``..trace.Records``) and ``work`` (the traced requests, as
``..roofline``'s counts take them)."""

from __future__ import annotations

import importlib


def read(spec: dict, ctx: dict):
    module = importlib.import_module(f"{__name__}.{spec['reader']}")
    return module.read(spec, ctx)
