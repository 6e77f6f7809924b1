"""``correct`` on the CPU at a small size: sound runs of the program pass
the cells' limits; the control (the reference one precision below the
tier) and runs with the timed path broken underneath do not."""

from __future__ import annotations

import time

import pytest
import torch

from ssw_bench import program, reference as R, run
from ssw_bench.tests.conftest import WORKLOADS, tiny_cell


def _execute(cell, prog, seed=21):
    return run.execute(cell, prog, torch.device("cpu"), seed, 0.3, False,
                       time.perf_counter())[0]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_runs_are_correct(workload):
    out = _execute(tiny_cell(workload), program.load())
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    from ssw_bench import drivers

    cell = tiny_cell(workload)
    d = drivers.get(cell["traffic"]["driver"])(cell, program.load(),
                                               torch.device("cpu"), 31)
    d.plan(0.3)
    d.setup()
    d.window(0.3)
    d.free()
    bits = R.CONTROL_BITS[cell["config"]["precision"]]
    checks = run.judge(d.check(d.control_outputs(bits)), cell["limits"])
    assert not all(c["ok"] for c in checks.values()), checks


class Broken:
    """The program with one fault planted in its timed path."""

    def __init__(self, fault: str):
        self.real = program.load()
        self.fault = fault
        self.pipeline = self
        for name in ("config", "kernels", "build", "write_config",
                     "read_config", "launch_counts", "build_info"):
            setattr(self, name, getattr(self.real, name))

    def __getattr__(self, name):
        return getattr(self.real.pipeline, name)

    # mark
    def embed_verified(self, rgb, marks, cfg):
        marked, ext = self.real.pipeline.embed_verified(rgb, marks, cfg)
        if self.fault == "unchanged":      # the image comes back as it was
            return rgb.clone(), ext
        if self.fault == "half":           # half of the batch left out
            h = rgb.shape[0] // 2
            marked = torch.cat([marked[:h], rgb[h:]])
            ext = torch.cat([ext[:h], ext[:h]])
        return marked, ext

    # detect
    def _half(self, ext):
        h = ext.shape[0] // 2
        return torch.cat([ext[:h], ext[:h]]) if self.fault == "half" else ext

    def extract_prepared(self, flat, idx, derived_flat, cfg):
        if self.fault == "unchanged":      # the suspects are never read
            derived_flat = flat
        return self._half(self.real.pipeline.extract_prepared(
            flat, idx, derived_flat, cfg))

    def similarity(self, ext, marks):
        sims = self.real.pipeline.similarity(ext, marks)
        if self.fault == "answer":         # an answer altered where made
            return torch.roll(sims, 1, dims=-1)
        return sims


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    out = _execute(tiny_cell(workload), Broken(fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_window_after_reset_is_judged_alone(workload):
    """A second window after ``reset()`` (a trace that lost records is
    taken again so) keeps only its own spans and outputs, and is correct."""
    from ssw_bench import drivers

    cell = tiny_cell(workload)
    d = drivers.get(cell["traffic"]["driver"])(cell, program.load(),
                                               torch.device("cpu"), 41)
    d.plan(0.3)
    d.setup()
    d.window(0.3)
    d.reset()
    d.window(0.3)
    assert d.counts()["failed"] == 0
    assert min(s for _, s, _ in d.spans.items) >= d.t0
    outputs = d.outputs()
    d.free()
    checks = run.judge(d.check(outputs), cell["limits"])
    assert all(c["ok"] for c in checks.values()), checks
