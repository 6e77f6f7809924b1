"""Configuration enums and dataclasses for the PyTorch pipelines.

A copy of the JAX package's ``config`` (same names, same string values, same
defaults), so that a config written for one package maps onto the other by
enum value (see :func:`..interop.config_from_reference`). The port cannot
import the JAX package's module instead: that package's ``__init__`` imports
``jax``. ``jax_precision`` has no counterpart here.

Defaults match the reference: Option2 insertion/extraction with alpha=0.1 and
Energy ordering (reference: src/algorithm.rs:104-112, 132-140).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional


class Method(str, enum.Enum):
    """Patent step-42 modulation equations (reference: src/algorithm.rs:68-77).

    - OPTION1: ``x' = x + alpha * w``       (alpha is absolute, not relative)
    - OPTION2: ``x' = x * (1 + alpha * w)`` (the paper's/reference's default)
    - OPTION3: ``x' = x * exp(alpha * w)``
    """

    OPTION1 = "option1"
    OPTION2 = "option2"
    OPTION3 = "option3"


class Ordering(str, enum.Enum):
    """Coefficient ranking metric (reference: src/algorithm.rs:143-152).

    - ENERGY: descending by ``v**2`` (DC coefficient excluded).
    - ENERGY_ORTHOGONAL: like ENERGY but each coefficient is first rescaled by
      the scipy-ortho normalization factor for its (row, col) position.
    - LEGACY: descending by the *raw, signed* ortho-rescaled value -- the
      preserved 2013 bug (reference: src/algorithm.rs:223-232).
    """

    ENERGY = "energy"
    ENERGY_ORTHOGONAL = "energy-orthogonal"
    LEGACY = "legacy"


class Precision(str, enum.Enum):
    """Precision tier of the DCT passes.

    DEFAULT   = bf16 operands, f32 accumulation (the fastest tier)
    HIGH      = bf16x3: hi/lo bf16 parts, three products (near-f32)
    HIGHEST   = full f32 (the reference-exact tier, every config's default)
    """

    DEFAULT = "default"
    HIGH = "high"
    HIGHEST = "highest"


#: Current fast-tier ranking generation (see the JAX package's config).
#: Generation 1 (``rank_version=1``) is the legacy stored format; both run.
RANK_VERSION = 2


@dataclasses.dataclass(frozen=True)
class InsertExtract:
    """Method + strength pair (reference CLI ``SerializableInsertExtract``,
    examples/main.rs:62-71)."""

    alpha: float = 0.1
    method: Method = Method.OPTION2


@dataclasses.dataclass(frozen=True)
class WriteConfig:
    """Embedding configuration (reference: src/algorithm.rs:99-112)."""

    insertion: InsertExtract = InsertExtract()
    ordering: Ordering = Ordering.ENERGY
    precision: Precision = Precision.HIGHEST
    # Custom insertion (indices, original, mark) -> new values, a torch
    # callable.
    custom_insert: Optional[Callable] = None
    # Custom ranking metric (flat_indices, values) -> metric, a torch
    # callable; overrides ``ordering``.
    custom_ordering: Optional[Callable] = None
    rank_version: int = RANK_VERSION

    def __hash__(self):
        return hash((self.insertion, self.ordering, self.precision,
                     self.rank_version,
                     id(self.custom_insert) if self.custom_insert else None,
                     id(self.custom_ordering) if self.custom_ordering else None))


@dataclasses.dataclass(frozen=True)
class ReadConfig:
    """Extraction configuration (reference: src/algorithm.rs:127-140)."""

    extraction: InsertExtract = InsertExtract()
    ordering: Ordering = Ordering.ENERGY
    precision: Precision = Precision.HIGHEST
    # Custom extraction (indices, base, derived) -> mark, a torch callable.
    custom_extract: Optional[Callable] = None
    custom_ordering: Optional[Callable] = None
    rank_version: int = RANK_VERSION

    def __hash__(self):
        return hash((self.extraction, self.ordering, self.precision,
                     self.rank_version,
                     id(self.custom_extract) if self.custom_extract else None,
                     id(self.custom_ordering) if self.custom_ordering else None))
