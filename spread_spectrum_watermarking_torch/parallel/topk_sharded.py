"""Exact distributed top-k over sharded coefficient blocks.

Port of the JAX package's ``parallel/topk_sharded.py``. The global top-n
is recovered from per-rank candidates: each rank takes its local top-n,
the candidates are all-gathered over the spatial axis (n values per
rank), and a final top-n over them is exact, because the global top-n is
a subset of the union of the per-rank top-n.

Ties follow the single-device ``ops.ranking.top_indices``: metric
descending, then global index ascending. Both stages select through
``ranking._top_by_key`` (K3 on the card), which breaks ties by a position:
locally on the f32 metric's total order with the local position as the
tie break (``lax.top_k``'s rule), finally on (metric desc, global index
asc) with -0.0 equal to +0.0, as the JAX package's final ``lexsort``
compares them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Ordering
from ..ops import ranking
from .mesh import SPATIAL_AXIS, Mesh


def _coords(h: int, wb: int, col_offset: int, device: torch.device):
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(wb, device=device)[None, :] + col_offset
    return rows, cols


def local_block_metric(
    coeffs_block: torch.Tensor,
    ordering: Ordering,
    height: int,
    width: int,
    col_offset: int,
) -> torch.Tensor:
    """Ranking metric of a (..., H, W/n) column block at ``col_offset``.

    The ortho orderings need each coefficient's *global* (row, col)
    position (reference: src/algorithm.rs:252-254), so the scale map is
    rebuilt from global coordinates: the f32 product of the row and column
    factors, then times the value, in the JAX package's order (equal inputs
    give equal metrics).
    """
    h, wb = coeffs_block.shape[-2], coeffs_block.shape[-1]
    if ordering == Ordering.ENERGY:
        return coeffs_block * coeffs_block
    s_k0_w = np.float32(np.sqrt(1.0 / (4.0 * width)))
    s_w = np.float32(np.sqrt(1.0 / (2.0 * width)))
    s_k0_h = np.float32(np.sqrt(1.0 / (4.0 * height)))
    s_h = np.float32(np.sqrt(1.0 / (2.0 * height)))
    rows, cols = _coords(h, wb, col_offset, coeffs_block.device)
    f32 = dict(dtype=torch.float32, device=coeffs_block.device)
    row_f = torch.where(rows == 0, torch.tensor(s_k0_w, **f32),
                        torch.tensor(s_w, **f32))
    col_f = torch.where(cols == 0, torch.tensor(s_k0_h, **f32),
                        torch.tensor(s_h, **f32))
    scaled = coeffs_block * (row_f * col_f)
    if ordering == Ordering.ENERGY_ORTHOGONAL:
        return scaled * scaled
    if ordering == Ordering.LEGACY:
        return scaled
    raise ValueError(f"unknown ordering {ordering}")


def distributed_top_indices(
    coeffs_block: torch.Tensor,
    n: int,
    ordering: Ordering,
    height: int,
    width: int,
    mesh: Mesh,
) -> torch.Tensor:
    """Global top-n flat indices from this rank's column block.

    ``coeffs_block`` is this rank's (..., Hp, Wp/s) column block of the DCT
    coefficients, Hp/Wp possibly padded up from the true ``height`` and
    ``width`` (``dct_sharded``). Returns the (..., n) int64 rank-ordered
    global flat indices (row-major over the true height x width image), DC
    and padding excluded, the same on every rank of the spatial axis.
    """
    h, wb = coeffs_block.shape[-2], coeffs_block.shape[-1]
    col_offset = mesh.index(SPATIAL_AXIS) * wb
    metric = local_block_metric(coeffs_block, ordering, height, width,
                                col_offset)
    rows, cols = _coords(h, wb, col_offset, coeffs_block.device)
    gidx = (rows * width + cols).reshape(-1)
    # DC exclusion (reference: src/algorithm.rs:204) and padding exclusion
    # (positions beyond the true height/width would otherwise alias valid
    # flat indices of later rows).
    keep = ((rows < height) & (cols < width)).reshape(-1) & (gidx != 0)
    key = ranking._f32_key(
        metric.to(torch.float32).reshape(*metric.shape[:-2], h * wb)
        .contiguous())
    key = torch.where(keep, key, ranking._NEG_INF_KEY)

    k_local = min(n, h * wb)
    li = ranking._top_by_key(key, None, k_local)
    lv = torch.gather(key, -1, li)
    lgi = gidx[li]

    # Gather the (key, global index) candidates of every rank.
    cand_k = torch.cat(mesh.all_gather(lv).unbind(0), dim=-1)
    cand_i = torch.cat(mesh.all_gather(lgi).unbind(0), dim=-1)

    # Final exact top-n with the single-device tie rule (lower global index
    # first), -0.0 and +0.0 equal as in the JAX package's lexsort.
    order = ranking._top_by_key(ranking._zeros_tie(cand_k), cand_i, n)
    return torch.gather(cand_i, -1, order)
