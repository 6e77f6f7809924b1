"""Watermark modulation: patent step-42 insert/extract equations + similarity.

Port of the JAX package's ``ops/modulation.py``. Multi-mark embedding is
delta-additive against the *original* coefficients (reference:
src/algorithm.rs:382-410); a single mark applies the equation directly.
"""

from __future__ import annotations

import torch

from ..config import Method, Precision
from .dct import matmul


def insert_values(method: Method, alpha: float, original: torch.Tensor,
                  mark: torch.Tensor) -> torch.Tensor:
    """Apply one insertion equation elementwise (reference: algorithm.rs:414-432)."""
    if method == Method.OPTION1:
        return original + alpha * mark
    if method == Method.OPTION2:
        return original * (1.0 + alpha * mark)
    if method == Method.OPTION3:
        return original * torch.exp(alpha * mark)
    raise ValueError(f"unknown method {method}")


def extract_values(method: Method, alpha: float, base: torch.Tensor,
                   derived: torch.Tensor) -> torch.Tensor:
    """Invert one insertion equation elementwise (reference: algorithm.rs:566-593)."""
    if method == Method.OPTION1:
        return (derived - base) / alpha
    if method == Method.OPTION2:
        return (derived - base) / (base * alpha)
    if method == Method.OPTION3:
        return torch.log(derived / base) / alpha
    raise ValueError(f"unknown method {method}")


def embed_marks(original: torch.Tensor, marks: torch.Tensor, method: Method,
                alpha: float) -> torch.Tensor:
    """New (..., n) values from the gathered (..., n) ``original`` and
    ``marks`` of shape (..., n) (one mark) or (..., M, n) (M marks)."""
    if marks.ndim == original.ndim:
        return insert_values(method, alpha, original, marks)
    if marks.shape[-2] == 1:
        return insert_values(method, alpha, original, marks[..., 0, :])
    deltas = insert_values(method, alpha, original[..., None, :],
                           marks) - original[..., None, :]
    return original + deltas.sum(dim=-2)


def similarity(extracted: torch.Tensor, candidates: torch.Tensor,
               precision: Precision = Precision.HIGHEST) -> torch.Tensor:
    """Cox et al. statistic ``X*.X / sqrt(X*.X*)``: (..., N) x (K, N) -> (..., K).

    One ``torch.matmul`` at the tier ``precision`` (``ops.dct.matmul``): f32
    with TF32 off at HIGHEST, the JAX package's default; the bf16x3 split at
    HIGH; bf16 operands with f32 sums at DEFAULT. Under the null hypothesis
    each entry is ~N(0, 1), so a threshold of k means "k sigma" (reference:
    src/algorithm.rs:696-714).
    """
    nom = matmul(extracted, candidates.t(), precision)
    den = torch.sqrt(torch.sum(extracted * extracted, dim=-1, keepdim=True))
    return nom / den


def exceeds_sigma(sim: torch.Tensor, n_sigma: float) -> torch.Tensor:
    """Plain ``>`` on the raw statistic (reference: src/algorithm.rs:677-679)."""
    return sim > n_sigma
