"""Spatially-sharded 2-D DCT for images too large for one device.

Port of the JAX package's ``parallel/dct_sharded.py``. The separable 2-D
DCT over a row-sharded image needs a reshard between the row pass and the
column pass: each rank transforms its rows, then an all-to-all over the
spatial axis re-tiles the array column-sharded so the column pass is also
local. The inverse runs the column pass first, then the all-to-all back to
rows, then the row pass.

Any size is accepted: the plane is zero-padded up to a multiple of the
spatial axis size and the cosine bases are zero-extended, so padding adds
nothing to any coefficient; the public wrappers crop. The ``*_padded``
forms take and return this rank's block of the padded layout, for the
pipelines that keep it: row block ``(..., Hp/s, Wp)`` in, column block
``(..., Hp, Wp/s)`` out, and the reverse for the inverse.

Each local product is ``ops.dct.matmul`` at the tier (HIGHEST: f32 with
TF32 off). The JAX package computes these passes outside any Pallas
kernel, as plain einsums, so they are ``torch.matmul`` here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import Precision
from ..kernels.dct2d_fused import inverse_scale
from ..ops.dct import dct2_basis, dct3_basis, matmul
from .mesh import SPATIAL_AXIS, Mesh, padded_size, place


@functools.lru_cache(maxsize=64)
def _dct2_basis_padded(n: int, n_pad: int, ortho: bool = False) -> np.ndarray:
    """Forward basis zero-extended to (n_pad, n_pad): rows/cols >= n are zero,
    so padded inputs contribute nothing and padded outputs are zero."""
    c = np.zeros((n_pad, n_pad), dtype=np.float32)
    c[:n, :n] = dct2_basis(n, ortho)
    return c


@functools.lru_cache(maxsize=64)
def _dct3_basis_padded(n: int, n_pad: int) -> np.ndarray:
    d = np.zeros((n_pad, n_pad), dtype=np.float32)
    d[:n, :n] = dct3_basis(n)
    return d


@functools.lru_cache(maxsize=64)
def padded_basis(n: int, n_pad: int, device: torch.device,
                 inverse: bool = False, ortho: bool = False) -> torch.Tensor:
    """The zero-extended f32 basis as a tensor on ``device``, cached."""
    c = _dct3_basis_padded(n, n_pad) if inverse else _dct2_basis_padded(
        n, n_pad, ortho)
    return torch.from_numpy(c).to(device)


def _pad_last2(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    if h == hp and w == wp:
        return x
    return torch.nn.functional.pad(x, (0, wp - w, 0, hp - h))


def dct2_2d_sharded_padded(
    y_block: torch.Tensor,
    mesh: Mesh,
    height: int,
    width: int,
    *,
    ortho: bool = False,
    precision: Precision = Precision.HIGHEST,
) -> torch.Tensor:
    """Forward sharded DCT on this rank's row block ``(..., Hp/s, Wp)`` of
    an already-padded plane; returns its column block ``(..., Hp, Wp/s)``.

    ``height``/``width`` are the true (pre-pad) sizes; the padded region
    must be zero on input and is zero on output.
    """
    hl, wp = y_block.shape[-2], y_block.shape[-1]
    n = mesh.shape[SPATIAL_AXIS]
    hp = hl * n
    assert wp % n == 0, (hp, wp, n)
    ch = padded_basis(height, hp, y_block.device, ortho=ortho)
    cw = padded_basis(width, wp, y_block.device, ortho=ortho)
    # Row pass on the local row block: (Hp/n, Wp) @ (Wp, Wp)^T.
    t = matmul(y_block, cw.t(), precision)
    # Reshard rows -> columns: (Hp/n, Wp) -> (Hp, Wp/n).
    t = mesh.all_to_all(t, split_axis=-1, concat_axis=-2)
    # Column pass, local on the column block: (Hp, Hp) @ (Hp, Wp/n).
    return matmul(ch, t, precision)


def idct2_2d_sharded_padded(
    x_block: torch.Tensor,
    mesh: Mesh,
    height: int,
    width: int,
    *,
    precision: Precision = Precision.HIGHEST,
) -> torch.Tensor:
    """Inverse sharded DCT on this rank's column block ``(..., Hp, Wp/s)``
    of a padded coefficient plane; returns its row block ``(..., Hp/s,
    Wp)``, valid where the global row and column are below ``height`` and
    ``width``."""
    hp, wb = x_block.shape[-2], x_block.shape[-1]
    n = mesh.shape[SPATIAL_AXIS]
    wp = wb * n
    assert hp % n == 0, (hp, wp, n)
    dh = padded_basis(height, hp, x_block.device, inverse=True)
    dw = padded_basis(width, wp, x_block.device, inverse=True)
    # Column pass on the local column block: (Hp, Hp) @ (Hp, Wp/n).
    t = matmul(dh, x_block, precision)
    # Reshard columns -> rows: (Hp, Wp/n) -> (Hp/n, Wp).
    t = mesh.all_to_all(t, split_axis=-2, concat_axis=-1)
    # Row pass local: (Hp/n, Wp) @ (Wp, Wp)^T, then the global factor.
    return matmul(t, dw.t(), precision) * inverse_scale(height, width)


def _crop_block(x: torch.Tensor, dim: int, index: int, size: int
                ) -> torch.Tensor:
    """Block ``index`` (of width ``x.shape[dim]``) cropped to the global
    extent ``size`` along ``dim``."""
    b = x.shape[dim]
    return x.narrow(dim, 0, max(0, min(b, size - index * b)))


def dct2_2d_sharded(
    y,
    mesh: Mesh,
    *,
    ortho: bool = False,
    precision: Precision = Precision.HIGHEST,
) -> torch.Tensor:
    """Forward sharded DCT-II of the global plane ``y`` (..., H, W), the
    same on every rank: this rank's column block of the (..., H, W)
    coefficients, JAX's ``P(None, spatial)`` (the last block cropped when
    W does not divide).

    Scaling identical to :func:`..ops.dct.dct2_2d` (scipy non-ortho or
    ortho). Any (H, W) is accepted; non-divisible sizes are padded here
    and cropped on return.
    """
    h, w = y.shape[-2], y.shape[-1]
    n = mesh.shape[SPATIAL_AXIS]
    hp, wp = padded_size(h, n), padded_size(w, n)
    blk = place(y, mesh, {-2: SPATIAL_AXIS}, pad=(-2,)).to(torch.float32)
    out = dct2_2d_sharded_padded(_pad_last2(blk, blk.shape[-2], wp), mesh,
                                 h, w, ortho=ortho, precision=precision)
    return _crop_block(out[..., :h, :], -1, mesh.index(SPATIAL_AXIS), w)


def idct2_2d_sharded(
    x,
    mesh: Mesh,
    *,
    precision: Precision = Precision.HIGHEST,
) -> torch.Tensor:
    """Inverse sharded DCT of the global coefficient plane ``x`` (..., H,
    W): this rank's row block of the (..., H, W) result, JAX's
    ``P(spatial, None)`` (the last block cropped when H does not divide)."""
    h, w = x.shape[-2], x.shape[-1]
    n = mesh.shape[SPATIAL_AXIS]
    hp = padded_size(h, n)
    blk = place(x, mesh, {-1: SPATIAL_AXIS}, pad=(-1,)).to(torch.float32)
    out = idct2_2d_sharded_padded(_pad_last2(blk, hp, blk.shape[-1]), mesh,
                                  h, w, precision=precision)
    return _crop_block(out[..., :w], -2, mesh.index(SPATIAL_AXIS), h)
