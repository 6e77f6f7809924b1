"""Load drivers: one module per kind of traffic, named by the traffic
file's ``driver`` key. Each defines ``Driver(cell, program, device,
seed)`` with ``plan(seconds)``, ``setup()``, ``window(seconds)``,
``reset()`` (the window's record cleared, for another window),
``metrics(seconds)``, ``counts()``, ``issue_ms()``, ``work()``
(``detect``: ``late_ms()``), ``free()``, ``outputs()``, ``control_outputs(bits)`` and
``check(outputs)``, and the host's ``spans`` and set-up ``phases``."""

from __future__ import annotations

import contextlib
import gc
import importlib
import time

import torch


def get(name: str):
    return importlib.import_module(f"{__name__}.{name}").Driver


class Done:
    """A request's completion mark: a CUDA event on a card, nothing to wait
    for on the CPU (its work ran when it was issued)."""

    def __init__(self, device: torch.device):
        self._ev = None
        if device.type == "cuda":
            self._ev = torch.cuda.Event()
            self._ev.record()

    def wait(self) -> None:
        if self._ev is not None:
            self._ev.synchronize()


def host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A host tensor that a device copy can fill without waiting."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host activity of the window, on ``time.perf_counter``: a list of
    ``(label, start, end)``, for naming the device's idle gaps."""

    def __init__(self):
        self.items = []

    def add(self, label: str, start: float, end: float) -> None:
        self.items.append((label, start, end))


@contextlib.contextmanager
def frozen_heap():
    """The window with set-up's heap frozen: what is alive is collected
    and moved out of the cyclic collector's reach before the window
    (set-up's time), so a collection in the window walks only what the
    program and the harness make there, as in a long-running process. The
    collector stays on."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


class Phases:
    """Set-up's phases on the host clock: ``{name: seconds}``, each ended
    with the device synchronised."""

    def __init__(self, device: torch.device):
        self.device, self.items = device, {}
        self._t = time.perf_counter()

    def done(self, name: str) -> None:
        sync(self.device)
        t = time.perf_counter()
        self.items[name] = t - self._t
        self._t = t
