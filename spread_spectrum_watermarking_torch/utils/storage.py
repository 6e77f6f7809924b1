"""Watermark database: versioned JSON store + legacy 2013 ``.wm`` reader.

Schema parity with the reference CLI (reference: examples/main.rs:110-131):

```json
{"Version1": {
    "config": {"insert_extract": {"alpha": 0.1, "method": "Option2"},
                "ordering": "Energy"},
    "watermarks": [{"values": [...], "description": "..."}]}}
```

Legacy ``.wm`` files (the author's 2013 Python tool) carry
``{"alpha": .., "length": .., "version": .., "wm": [...]}`` and are
interpreted as Option2 insertion with Legacy ordering
(reference: examples/main.rs:321-344).

This is the framework's durable state -- the closest thing the reference has
to checkpointing (SURVEY.md section 5) -- so the format, including the
enum-style serde spellings, is preserved exactly for cross-tool reads.

A copy of the JAX package's module on the port's ``config``: the same
spelling tables, errors and JSON, so a file saved by either package has
the same bytes and each package reads the other's files. The port writes
the JAX package's fast-tier spellings; its exact selection may order
near-ties on the bf16 plane differently from JAX's ``approx_max_k``, which
the JAX package already accepts between its own TPU and CPU builds under
one spelling.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

from ..config import RANK_VERSION, InsertExtract, Method, Ordering, Precision

# serde spellings used by the reference CLI's enums (examples/main.rs:10-49).
_METHOD_TO_JSON = {
    Method.OPTION1: "Option1",
    Method.OPTION2: "Option2",
    Method.OPTION3: "Option3",
}
_JSON_TO_METHOD = {v: k for k, v in _METHOD_TO_JSON.items()}

_ORDERING_TO_JSON = {
    Ordering.ENERGY: "Energy",
    Ordering.ENERGY_ORTHOGONAL: "EnergyOrthogonal",
    Ordering.LEGACY: "Legacy",
}
_JSON_TO_ORDERING = {v: k for k, v in _ORDERING_TO_JSON.items()}

# Fast-tier spellings carry the RANKING GENERATION (ops/ranking.py
# COMPATIBILITY CONTRACT): the rank order a fast tier derives is part of the
# stored format, and it changed between generation 1 (bf16-key selection +
# value gather) and generation 2 (gather-free, sign-in-key-LSB). A mark file
# therefore names its (tier, generation) pair so it always reads back with
# the exact ranking it was embedded under. "Highest" is exact at every
# generation and needs no suffix.
_PRECISION_TO_JSON = {
    (Precision.HIGHEST, 1): "Highest",
    (Precision.HIGHEST, 2): "Highest",
    (Precision.HIGH, 1): "High",
    (Precision.DEFAULT, 1): "Default",
    (Precision.HIGH, 2): "High2",
    (Precision.DEFAULT, 2): "Default2",
}
_JSON_TO_PRECISION = {
    "Highest": (Precision.HIGHEST, RANK_VERSION),
    "High": (Precision.HIGH, 1),
    "Default": (Precision.DEFAULT, 1),
    "High2": (Precision.HIGH, 2),
    "Default2": (Precision.DEFAULT, 2),
}

# MIGRATION NOTE (unversioned gather-free window): builds between the
# gather-free generation-2 ranking landing and the versioned spellings
# landing (repo commits 5df7152..7f3be14) ranked at generation 2 but still
# wrote the unsuffixed "Default"/"High" spellings. Files from that window
# read back here as generation 1 (the only safe default -- every release
# before the window is generation 1) and will extract with the wrong rank
# order; re-read them with the explicit override ``ssw-tpu test
# --rank-version 2`` (which bypasses this table's generation mapping).
#
# MIGRATION NOTE (deleted 4K Pallas prologue, commit b5b6c44): fast-tier
# marks embedded ON TPU at 4K-class sizes (min(H, W) >= 2000) by the
# rounds-3/4 builds ranked through the since-deleted kernel's metric
# plane, whose bf16 rounding differed from the XLA plane on near-tie
# energies. Reading such files with this build can flip a handful of
# near-tie rank positions (similarity degrades by at most a few tenths of
# a sigma out of ~31) -- the same magnitude of divergence those files
# always had when read on a non-TPU backend, where the kernel never
# dispatched. No spelling or version key distinguishes this; it is a
# formulation change within a tier, documented here for completeness.


def _lookup_spelling(table: dict, value, what: str):
    """Map a stored serde spelling, failing loudly on unknown ones.

    A file written by a future tool generation (the forward-compat scenario
    the ops/ranking.py COMPATIBILITY CONTRACT contemplates, e.g. a
    hypothetical "Default3") must name the offending spelling and the
    supported set -- like the reference's serde error
    (reference: examples/main.rs:363-365) -- not die with a KeyError.
    """
    try:
        return table[value]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown {what} {value!r} in watermark storage; supported "
            f"spellings: {sorted(table)}. The file may have been written by "
            f"a newer tool generation.") from None


@dataclasses.dataclass(frozen=True)
class Configuration:
    """Stored configuration (reference ``Configuration``, examples/main.rs:110-114).

    Embedded in the JSON so extraction self-describes.
    """

    insert_extract: InsertExtract = InsertExtract()
    ordering: Ordering = Ordering.ENERGY


@dataclasses.dataclass
class DescribedWatermark:
    values: List[float]
    description: str = ""


@dataclasses.dataclass
class WatermarkStorage:
    """The ``Version1`` storage envelope (examples/main.rs:122-131).

    ``precision`` extends the reference schema: the rank order the fast
    (non-HIGHEST) tiers derive from a bf16-computed coefficient plane is
    deterministic per tier but differs *across* tiers on near-tie energies,
    so extraction must run at the tier the watermark was embedded at. The
    embedding tier is therefore recorded alongside the config (an optional
    key the reference's serde ignores); absent -- including in every
    reference-written file -- it means ``Highest``, the tier whose ordering
    is exact and matches the reference's (value desc, index asc) sort.

    ``rank_version`` names the fast-tier ranking generation the mark was
    embedded under (config.RANK_VERSION); it rides inside the precision
    spelling ("Default"/"High" = generation 1, "Default2"/"High2" =
    generation 2) so files self-describe without a second schema key.
    """

    config: Configuration
    watermarks: List[DescribedWatermark]
    precision: Optional[Precision] = None
    rank_version: int = RANK_VERSION

    def to_json(self) -> str:
        v1 = {
            "config": {
                "insert_extract": {
                    "alpha": self.config.insert_extract.alpha,
                    "method": _METHOD_TO_JSON[self.config.insert_extract.method],
                },
                "ordering": _ORDERING_TO_JSON[self.config.ordering],
            },
            "watermarks": [
                {"values": [float(v) for v in wm.values],
                 "description": wm.description}
                for wm in self.watermarks
            ],
        }
        if self.precision is not None:
            v1["precision"] = _PRECISION_TO_JSON[
                (self.precision, self.rank_version)]
        return json.dumps({"Version1": v1}, indent=2)

    @staticmethod
    def from_json(text: str) -> "WatermarkStorage":
        obj = json.loads(text)
        if "Version1" not in obj:
            raise ValueError(f"unknown watermark storage version: {list(obj)}")
        v1 = obj["Version1"]
        cfg = v1["config"]
        config = Configuration(
            insert_extract=InsertExtract(
                alpha=float(cfg["insert_extract"]["alpha"]),
                method=_lookup_spelling(_JSON_TO_METHOD,
                                        cfg["insert_extract"]["method"],
                                        "insert/extract method"),
            ),
            ordering=_lookup_spelling(_JSON_TO_ORDERING, cfg["ordering"],
                                      "ordering"),
        )
        watermarks = [
            DescribedWatermark(values=wm["values"],
                               description=wm.get("description", ""))
            for wm in v1["watermarks"]
        ]
        if "precision" in v1:
            precision, rank_version = _lookup_spelling(
                _JSON_TO_PRECISION, v1["precision"], "precision tier")
        else:
            precision, rank_version = None, RANK_VERSION
        return WatermarkStorage(config=config, watermarks=watermarks,
                                precision=precision,
                                rank_version=rank_version)


def interpret_legacy_watermark(text: str) -> WatermarkStorage:
    """Upgrade a 2013 ``.wm`` JSON file (reference: examples/main.rs:321-344)."""
    obj = json.loads(text)
    return WatermarkStorage(
        config=Configuration(
            insert_extract=InsertExtract(alpha=float(obj["alpha"]),
                                         method=Method.OPTION2),
            ordering=Ordering.LEGACY,
        ),
        watermarks=[DescribedWatermark(values=obj["wm"], description="")],
    )


def load_watermark_file(path: str | os.PathLike) -> WatermarkStorage:
    """Load either a Version1 ``.json`` or a legacy ``.wm`` file.

    Dispatch on the ``.wm`` suffix like the reference CLI
    (examples/main.rs:358-366).
    """
    with open(path) as f:
        text = f.read()
    if str(path).endswith(".wm"):
        return interpret_legacy_watermark(text)
    return WatermarkStorage.from_json(text)


def save_watermark_file(path: str | os.PathLike, storage: WatermarkStorage) -> None:
    with open(path, "w") as f:
        f.write(storage.to_json())
