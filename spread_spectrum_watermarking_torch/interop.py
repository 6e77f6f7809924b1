"""Carry state from the JAX package into the port.

The system has no weights: its state is the configs, the marks and the
Reader's cache: ``prepare_base``'s coefficients and indices at HIGHEST,
``rank_base``'s indices and values at the fast tier. These helpers turn the
JAX package's versions of them into the port's, so that both packages can
compute on the same state. They take plain Python and numpy values and
never import ``jax``: a JAX config is read by duck typing and enum
``.value``, and JAX arrays are passed in as ``numpy.asarray(...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import (InsertExtract, Method, Ordering, Precision, ReadConfig,
                     WriteConfig)


def _insert_extract(ie) -> InsertExtract:
    return InsertExtract(alpha=float(ie.alpha), method=Method(ie.method.value))


def config_from_reference(cfg) -> WriteConfig | ReadConfig:
    """The port's config for a JAX ``WriteConfig`` or ``ReadConfig``."""
    customs = ("custom_insert", "custom_extract", "custom_ordering")
    if any(getattr(cfg, name, None) is not None for name in customs):
        raise ValueError("custom callables are JAX code; they do not carry over")
    common = dict(ordering=Ordering(cfg.ordering.value),
                  precision=Precision(cfg.precision.value),
                  rank_version=int(cfg.rank_version))
    if hasattr(cfg, "insertion"):
        return WriteConfig(insertion=_insert_extract(cfg.insertion), **common)
    return ReadConfig(extraction=_insert_extract(cfg.extraction), **common)


def rank_state_from_numpy(idx, vals, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(idx, base_vals)`` from JAX's ``rank_base`` -> int64 and f32 tensors."""
    return (torch.from_numpy(np.asarray(idx).astype(np.int64)).to(device),
            torch.from_numpy(np.asarray(vals, dtype=np.float32)).to(device))


def base_state_from_numpy(flat, idx, device) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``(base_flat, idx)`` from JAX's ``prepare_base`` (the HIGHEST
    Reader's cache) -> f32 and int64 tensors."""
    return (torch.from_numpy(np.asarray(flat, dtype=np.float32)).to(device),
            torch.from_numpy(np.asarray(idx).astype(np.int64)).to(device))


def marks_from_numpy(marks, device) -> torch.Tensor:
    """Marks (any float array-like) -> an f32 tensor of the same shape."""
    return torch.from_numpy(np.asarray(marks, dtype=np.float32)).to(device)
