"""Spread-spectrum image watermarking in PyTorch, with Hopper kernels.

The port of ``spread_spectrum_watermarking_tpu`` (the JAX reference, which
stays beside it). This package imports ``torch`` and numpy, never ``jax``.
It covers the three precision tiers: the reference-exact
``Precision.HIGHEST`` (every config's default) and the fast ``HIGH`` and
``DEFAULT`` tiers (rank generation 2): embed with the sparse or the full
inverse, embed-and-verify, extract, the reader-cached rank/extract pair,
the prepared base/derived pair, u8 or float images, and the
Writer/Reader/Tester wrappers. Importing it builds and loads no kernel.
"""

from .api import Reader, ReaderDerived, Similarity, Tester, Writer
from .config import (RANK_VERSION, InsertExtract, Method, Ordering, Precision,
                     ReadConfig, WriteConfig)
from .marks import as_marks, generate_normal
from .models.pipeline import (embed, embed_verified, extract, extract_prepared,
                              extract_ranked, prepare_base, prepare_derived,
                              rank_base, rank_plane, similarity)
from .ops.modulation import exceeds_sigma

__all__ = [
    "Writer", "Reader", "ReaderDerived", "Tester", "Similarity",
    "RANK_VERSION", "InsertExtract", "Method", "Ordering", "Precision",
    "ReadConfig", "WriteConfig", "as_marks", "generate_normal", "embed",
    "embed_verified", "extract", "extract_prepared", "extract_ranked",
    "prepare_base", "prepare_derived", "rank_base", "rank_plane",
    "similarity", "exceeds_sigma",
]
