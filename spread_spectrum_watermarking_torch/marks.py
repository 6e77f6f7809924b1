"""Watermark generation: N(0, 1) marks from an explicit ``torch.Generator``.

Port of the JAX package's ``marks.py`` (reference ``MarkBuf::generate_normal``,
src/algorithm.rs:608-645). The streams differ from ``jax.random``'s for the
same seed; to compute on the same marks in both packages, make them once
and pass them across (:func:`..interop.marks_from_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch


def generate_normal(key: torch.Generator, length: int,
                    count: int | None = None) -> torch.Tensor:
    """f32 N(0, 1) marks on the device of ``key``, the ``torch.Generator``
    that takes the place of the JAX package's ``jax.random`` key:
    ``(length,)`` when ``count`` is None, else ``(count, length)``."""
    shape = (length,) if count is None else (count, length)
    return torch.randn(shape, generator=key, dtype=torch.float32,
                       device=key.device)


def as_marks(values) -> np.ndarray:
    """Coerce any array-like of floats to a (M, N) float32 mark matrix."""
    arr = np.asarray(values, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    if arr.ndim != 2:
        raise ValueError(f"marks must be 1-D or 2-D, got shape {arr.shape}")
    return arr
