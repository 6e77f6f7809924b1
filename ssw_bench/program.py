"""The one door from the benchmark to the program under test.

The program is the PyTorch and CUDA port,
``spread_spectrum_watermarking_torch``. The benchmark takes from it only
its entry points, its launch counters and its build record; everything it
drives goes through :class:`Program`, so that a test can break the timed
path underneath a run.
"""

from __future__ import annotations

import dataclasses

PACKAGE = "spread_spectrum_watermarking_torch"


@dataclasses.dataclass
class Program:
    pipeline: object
    config: object
    kernels: object
    build: object

    def write_config(self, cfg: dict):
        c = self.config
        return c.WriteConfig(
            insertion=c.InsertExtract(alpha=cfg["alpha"],
                                      method=c.Method(cfg["method"])),
            ordering=c.Ordering(cfg["ordering"]),
            precision=c.Precision(cfg["precision"]),
            rank_version=cfg["rank_version"])

    def read_config(self, cfg: dict):
        c = self.config
        return c.ReadConfig(
            extraction=c.InsertExtract(alpha=cfg["alpha"],
                                       method=c.Method(cfg["method"])),
            ordering=c.Ordering(cfg["ordering"]),
            precision=c.Precision(cfg["precision"]),
            rank_version=cfg["rank_version"])

    def launch_counts(self) -> dict:
        return dict(self.kernels.launch_counts())

    def build_info(self) -> dict:
        return dict(self.build.BUILD_INFO)


def load() -> Program:
    """The port, imported; ImportError where the checkout lacks it."""
    import importlib

    return Program(
        pipeline=importlib.import_module(f"{PACKAGE}.models.pipeline"),
        config=importlib.import_module(f"{PACKAGE}.config"),
        kernels=importlib.import_module(f"{PACKAGE}.kernels"),
        build=importlib.import_module(f"{PACKAGE}.kernels._build"))
