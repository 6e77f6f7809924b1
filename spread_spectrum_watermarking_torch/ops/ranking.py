"""Coefficient ranking, in PyTorch.

Port of the JAX package's ``ops/ranking.py``: :func:`top_indices`, the
exact selection of the ``HIGHEST`` tier (equal to JAX's, index for index),
and ``approx_top_indices``, the fast tiers', at both rank generations and
with a custom metric.

In ``approx_top_indices`` the keys are built bit for bit as in JAX; what
differs is the selection. JAX takes ``lax.approx_max_k``, whose choice among equal keys at
the selection boundary is unspecified (and on a TPU approximate). The port
selects **exactly**, with the reference's tie rule: key descending, then
flat index ascending (Rust's stable sort over ascending indices,
src/algorithm.rs:204-205). Against JAX on the same plane the selected key
multisets agree and the indices differ only inside runs of equal keys.

The DC coefficient (flat index 0) is never selected ahead of another
coefficient (src/algorithm.rs:204 ``.skip(1)``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import Ordering
from ..kernels import topk_select


@functools.lru_cache(maxsize=64)
def _ortho_scale_map(height: int, width: int) -> np.ndarray:
    """Per-coefficient scipy-ortho rescale factor, shape (H, W).

    Row 0 pairs with the *width* factor and column 0 with the *height*
    factor, verbatim from the reference (src/algorithm.rs:240-267).
    """
    s_k0_w = np.sqrt(1.0 / (4.0 * width)).astype(np.float32)
    s_w = np.sqrt(1.0 / (2.0 * width)).astype(np.float32)
    s_k0_h = np.sqrt(1.0 / (4.0 * height)).astype(np.float32)
    s_h = np.sqrt(1.0 / (2.0 * height)).astype(np.float32)
    row_factor = np.full((height, 1), s_w, dtype=np.float32)
    row_factor[0, 0] = s_k0_w
    col_factor = np.full((1, width), s_h, dtype=np.float32)
    col_factor[0, 0] = s_k0_h
    return row_factor * col_factor


@functools.lru_cache(maxsize=16)
def _flat_scale(height: int, width: int, device: torch.device) -> torch.Tensor:
    """:func:`_ortho_scale_map` flattened, as an f32 tensor on ``device``."""
    return torch.from_numpy(_ortho_scale_map(height, width).reshape(-1)).to(device)


def _bits16(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> its 16 bits as int32 in [0, 65535]."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def _top_by_key(key: torch.Tensor, pos: torch.Tensor | None,
                n: int) -> torch.Tensor:
    """Positions (along the last axis) of the n largest int32 ``key``s,
    ordered by (key desc, ``pos`` asc), ``pos`` the flat indices (None: the
    positions themselves): K3's :func:`topk_select.top_by_key`, whose
    plain version selects on unique int64 composites."""
    return topk_select.top_by_key(
        key.contiguous(), None if pos is None else pos.contiguous(), n)


def _bf16_key(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> int32 in the value's order; -0.0 and +0.0 map to one key."""
    bits = _bits16(x.contiguous())
    mag = bits & 0x7FFF
    return torch.where(bits >= 0x8000, -mag, mag)


_DC_KEY = -0x8001  # below every bf16 key, -inf's included


def _metric_at(vals: torch.Tensor, idx: torch.Tensor, h: int, w: int,
               ordering: Ordering) -> torch.Tensor:
    """The f32 ranking metric of gathered values at flat ``idx`` (JAX
    ``_metric_from_values``; the caller masks DC)."""
    if ordering == Ordering.ENERGY:
        return vals * vals
    scaled = vals * _flat_scale(h, w, vals.device)[idx]
    if ordering == Ordering.ENERGY_ORTHOGONAL:
        return scaled * scaled
    if ordering == Ordering.LEGACY:
        return scaled
    raise ValueError(f"unknown ordering {ordering}")


def _select_and_resort(keys: torch.Tensor, flat_c: torch.Tensor, n: int,
                       metric_at) -> tuple[torch.Tensor, torch.Tensor]:
    """Generation 1's and the custom metric's selection: the n largest bf16
    ``keys`` (DC forced last), one gather of their values as f32, then the
    re-sort by (f32 metric desc, index asc), DC last, with -0.0 and +0.0
    equal as in ``lax.sort``: ``(indices, values)``."""
    keys[..., 0] = _DC_KEY
    idx = _top_by_key(keys, None, n)
    cand_c = torch.gather(flat_c, -1, idx).to(torch.float32)
    cand_m = torch.where(idx == 0, -float("inf"),
                         metric_at(idx, cand_c).to(torch.float32))
    order = _top_by_key(_zeros_tie(_f32_key(cand_m.contiguous())), idx, n)
    return torch.gather(idx, -1, order), torch.gather(cand_c, -1, order)


def approx_top_indices(
    coeffs: torch.Tensor,
    n: int,
    ordering: Ordering,
    custom_metric=None,
    version: int = 2,
):
    """Top-n of a bf16 plane (..., H, W): ``(indices, values)``, int64 flat
    indices in rank order and the f32 coefficient estimates there.

    The name is the JAX function's, so its counterpart can be found; the
    selection here is exact (module docstring). ``version`` is the rank
    generation, part of the stored format (JAX ``ranking.py``'s
    COMPATIBILITY CONTRACT); any other raises ``ValueError`` as in JAX.

    Generation 2 (built-in orderings): keys of ``|scaled|`` in bf16 with
    the coefficient's sign stored in the key's LSB (ENERGY,
    ENERGY_ORTHOGONAL), or the signed scaled value itself (LEGACY); DC is
    forced below every other key. Indices are ordered by (LSB-masked key
    desc, index asc) and the estimates rebuilt from the keys, 0.0 at DC:
    one K3 call (``kernels.topk_select.top_of_plane``; its plain version
    is that chain of plain ops).

    Generation 1: keys are the bf16-rounded ``ranking_metric`` of the plane
    (the f32 scale product and square rounded once, as XLA rounds the
    jitted chain), then one gather of the n values and a re-sort by the f32
    metric of those values. A ``custom_metric(flat_indices, values)`` (a
    torch callable; it sees int64 positions and the bf16 plane, then the
    gathered f32 values) takes the generation-1 route at either version.
    """
    if version not in (1, 2):
        raise ValueError(f"unknown fast-tier rank_version {version}")
    if coeffs.dtype != torch.bfloat16:
        raise TypeError("the fast-tier ranking takes a bf16 plane")
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    flat_c = coeffs.reshape(*coeffs.shape[:-2], h * w)
    if custom_metric is not None:
        pos = torch.arange(h * w, device=coeffs.device, dtype=torch.int64)
        keys = _bf16_key(custom_metric(pos, flat_c).to(torch.bfloat16))
        return _select_and_resort(keys, flat_c, n, custom_metric)
    if version == 1:
        m = ranking_metric(coeffs.to(torch.float32), ordering)
        keys = _bf16_key(m.to(torch.bfloat16).reshape(flat_c.shape))
        return _select_and_resort(
            keys, flat_c, n, lambda i, v: _metric_at(v, i, h, w, ordering))
    return topk_select.top_of_plane(coeffs.contiguous(), n, ordering)


def ranking_metric(coeffs: torch.Tensor, ordering: Ordering) -> torch.Tensor:
    """The per-coefficient f32 ranking metric (..., H, W), formed as the JAX
    package forms it: ENERGY ``v*v``; ENERGY_ORTHOGONAL ``(v*s)**2`` with
    ``s`` the f32 product of the row and column factors; LEGACY the signed
    ``v*s`` (the preserved 2013 bug, reference src/algorithm.rs:223-232)."""
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    if ordering == Ordering.ENERGY:
        return coeffs * coeffs
    scaled = coeffs * _flat_scale(h, w, coeffs.device).reshape(h, w)
    if ordering == Ordering.ENERGY_ORTHOGONAL:
        return scaled * scaled
    if ordering == Ordering.LEGACY:
        return scaled
    raise ValueError(f"unknown ordering {ordering}")


def _f32_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 in IEEE total order (-0.0 below +0.0), the order of
    ``lax.top_k`` and ``jnp.max``."""
    bits = x.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


_NEG_INF_KEY = int(_f32_key(torch.tensor([-float("inf")]))[0])
_NEG_ZERO_KEY = -1  # _f32_key(-0.0)


def _zeros_tie(key: torch.Tensor) -> torch.Tensor:
    """The same key with -0.0 raised to +0.0: the order of ``lax.sort``,
    which compares the two as equal."""
    return torch.where(key == _NEG_ZERO_KEY, 0, key)


def _tiled_top(key: torch.Tensor, n: int, tile: int) -> torch.Tensor:
    """The JAX package's ``_tiled_exact_top_k`` on total-order keys
    (..., size): the n best tiles of ``tile`` by their max (``lax.top_k``),
    recursively while the tiles are many, then the n best of their
    elements by (key desc, index asc) with ``lax.sort``'s equal zeros."""
    size = key.shape[-1]
    pad = (-size) % tile
    if pad:
        key = torch.cat([key, key.new_full((*key.shape[:-1], pad),
                                           _NEG_INF_KEY)], dim=-1)
    t = key.shape[-1] // tile
    tiles = key.reshape(*key.shape[:-1], t, tile)
    maxes = tiles.amax(dim=-1)
    if t >= n * tile:
        tile_ids = _tiled_top(maxes, n, tile)
    else:
        tile_ids = _top_by_key(maxes, None, n)
    cand = torch.gather(tiles, -2, tile_ids[..., None].expand(
        *tile_ids.shape, tile)).reshape(*tile_ids.shape[:-1], n * tile)
    offs = torch.arange(tile, device=key.device, dtype=torch.int64)
    cand_idx = (tile_ids[..., None] * tile + offs).reshape(cand.shape)
    order = _top_by_key(_zeros_tie(cand), cand_idx, n)
    return torch.gather(cand_idx, -1, order)


def top_indices(coeffs: torch.Tensor, n: int, ordering: Ordering,
                exact_only: bool = False, custom_metric=None) -> torch.Tensor:
    """Flat indices (..., n) int64 of the n strongest coefficients of an f32
    plane (..., H, W), DC excluded (reference src/algorithm.rs:200-210).

    Exact, with the reference's order: metric descending, then index
    ascending. Selected by K3 (``kernels.topk_select.top_by_key``) on
    order-preserving keys, and, like the JAX package, by one select over
    the plane when it is small (size < 4 n 32, or ``exact_only``) and by
    its tiled selection otherwise; on the card ENERGY and ENERGY_ORTHOGONAL
    take the one select at every size, the same function, through K3's f32
    mode (``kernels.topk_select.top_of_coeffs``) unless ``exact_only``. The two differ
    only in how -0.0 meets +0.0, which LEGACY's signed metric can hold:
    ``lax.top_k`` ranks +0.0 first, the tiled path's final ``lax.sort``
    ranks them as equal; the port reproduces both.

    A ``custom_metric(flat_indices, values)`` (a torch callable, given int64
    positions and the plane's values) replaces the built-in metric; its
    f32 result is selected the same way, DC excluded.
    """
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    size = h * w
    lead = coeffs.shape[:-2]
    # On the card, one select over the plane wherever it is the tiled
    # route's function: the built-in squares hold no -0.0, so _zeros_tie is
    # the identity there, and the JAX package's _tiled_exact_top_k
    # docstring (ranking.py:109-131) proves the tiled route equal to the
    # exact (metric desc, index asc) top-n. K3 builds the keys from the f32
    # coefficients in registers, so no metric or key plane is written. On
    # the CPU each route is JAX's.
    single = (coeffs.device.type == "cuda" and custom_metric is None
              and ordering in (Ordering.ENERGY, Ordering.ENERGY_ORTHOGONAL))
    if single and not exact_only:
        return topk_select.top_of_coeffs(
            coeffs.to(torch.float32).contiguous(), n, ordering)
    if custom_metric is not None:
        pos = torch.arange(size, device=coeffs.device, dtype=torch.int64)
        metric = custom_metric(pos, coeffs.reshape(*lead, size))
    else:
        metric = ranking_metric(coeffs.to(torch.float32), ordering)
    key = _f32_key(metric.to(torch.float32).reshape(*lead, size).contiguous())
    key[..., 0] = _NEG_INF_KEY  # DC, as the JAX package's -inf
    tile = 32
    if exact_only or size < 4 * n * tile or single:
        return _top_by_key(key, None, n)
    return _tiled_top(key, n, tile)
