"""DCT-II bases, the 2-D transforms and the 1-D passes, in PyTorch.

Port of the JAX package's ``ops/dct.py`` at the two ported tiers. The numpy
basis builders are copied verbatim, so both packages transform with
bit-identical bases (scipy scaling, reference src/dct2d.rs:105-118).

- ``Precision.HIGHEST``: full f32. The whole-image transforms
  :func:`dct2_2d` and :func:`idct2_2d` are kernels K6a/K6b on a CUDA
  tensor (``..kernels.dct2d_fused``), their plain versions on the CPU. The
  1-D passes, which the JAX package leaves to XLA, are f32 ``torch.matmul``
  with TF32 off (:func:`matmul_f32`).
- ``Precision.DEFAULT``: bf16 operands, f32 sums. The passes are
  ``torch.matmul`` on bf16 tensors with cuBLAS's reduced-precision
  reduction turned off (:func:`matmul_bf16`): by default cuBLAS may add
  split-K partial sums in bf16.

``Precision.HIGH`` and the folded transforms (``fold=True``) raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..config import Precision
from ..kernels import dct2d_fused


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md)")


@functools.lru_cache(maxsize=64)
def dct2_basis(n: int, ortho: bool = False) -> np.ndarray:
    """Forward DCT-II basis C with C[k, m] = 2 cos(pi k (2m+1) / (2N)).

    Applying ``x @ C.T`` transforms the last axis exactly like one scipy
    ``dct(x, type=2)`` pass (the reference's per-row/col operation at
    src/dct2d.rs:141,166: rustdct output times 2).

    With ``ortho=True`` rows are rescaled to scipy's ``norm='ortho'``:
    row 0 by sqrt(1/(4N)), rows k>0 by sqrt(1/(2N))
    (reference: src/dct2d.rs:153-162).
    """
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    c = 2.0 * np.cos(np.pi * k * (2.0 * m + 1.0) / (2.0 * n))
    if ortho:
        s = np.full((n, 1), np.sqrt(1.0 / (2.0 * n)))
        s[0, 0] = np.sqrt(1.0 / (4.0 * n))
        c = c * s
    return c.astype(np.float32)


@functools.lru_cache(maxsize=64)
def dct3_basis(n: int) -> np.ndarray:
    """Inverse (DCT-III) basis D with the reference's per-pass 0.5 scaling.

    rustdct's DCT-III is ``y_k = x_0/2 + sum_{m>=1} x_m cos(pi m (2k+1)/(2N))``
    and the reference halves every output (src/dct2d.rs:109). So
    ``D[k, 0] = 0.25`` and ``D[k, m] = 0.5 cos(pi m (2k+1) / (2N))`` for m>=1.
    The global ``4/(W*H)`` factor (src/dct2d.rs:213-218) is applied by
    :func:`idct2_2d`, not folded here, to mirror the reference's scaling
    structure.
    """
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    d = 0.5 * np.cos(np.pi * m * (2.0 * k + 1.0) / (2.0 * n))
    d[:, 0] = 0.25
    return d.astype(np.float32)


@functools.lru_cache(maxsize=64)
def basis_tensor(n: int, device: torch.device, dtype: torch.dtype,
                 inverse: bool = False, ortho: bool = False) -> torch.Tensor:
    """:func:`dct2_basis` (or :func:`dct3_basis`) as a cached tensor."""
    c = dct3_basis(n) if inverse else dct2_basis(n, ortho)
    return torch.from_numpy(c).to(device=device, dtype=dtype)


@contextlib.contextmanager
def _f32_sums():
    """No TF32 in f32 products and no bf16 split-K reduction in bf16 ones,
    for the duration of a call; the flags are restored after it."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = prev


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 with TF32 off: full-f32 products and sums."""
    with _f32_sums():
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands: exact products, f32 sums, one bf16
    rounding of each result."""
    with _f32_sums():
        return torch.matmul(a, b)


def shorter_axis(h: int, w: int) -> int:
    """The axis the first pass contracts: the shorter one, the cheaper full
    pass (the JAX package's ``pipeline._shorter_axis``)."""
    return -2 if h <= w else -1


def _require_highest(precision: Precision, fold: bool = False) -> None:
    if fold:
        raise _not_ported("fold=True (the folded pass, Queue 2 K1f)")
    if precision is not Precision.HIGHEST:
        raise _not_ported(f"the 2-D transform at precision {precision.value!r}")


def dct2_2d(x: torch.Tensor, *, ortho: bool = False,
            precision: Precision = Precision.HIGHEST,
            fold: bool = False) -> torch.Tensor:
    """2-D DCT-II over the last two axes (..., H, W) of an f32 ``x``, scipy
    scaling: ``(C_h @ X) @ C_w^T``, in the JAX package's association.

    A CUDA tensor runs kernel K6a; a CPU tensor its plain version.
    """
    _require_highest(precision, fold)
    return dct2d_fused.dct2_2d_fused(x, ortho=ortho)


def idct2_2d(x: torch.Tensor, *, precision: Precision = Precision.HIGHEST,
             fold: bool = False) -> torch.Tensor:
    """Inverse of :func:`dct2_2d` (non-ortho): ``(D_h @ X) @ D_w^T`` times
    ``f32(4/(W*H))``. A CUDA tensor runs kernel K6b; a CPU tensor its
    plain version."""
    _require_highest(precision, fold)
    return dct2d_fused.idct2_2d_fused(x)


def dct2_pass(x: torch.Tensor, *, axis: int, ortho: bool = False,
              precision: Precision = Precision.HIGHEST,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One 1-D DCT-II pass along ``axis`` (-1 or -2), scipy scaling.

    The basis takes ``x``'s dtype (f32 or bf16), products are exact and
    sums f32, as in the JAX package; the result is f32, or ``out_dtype``.
    ``Precision.DEFAULT`` takes only bf16 planes. A bf16 result is rounded
    once from the f32 sum.
    """
    if precision is Precision.HIGH:
        raise _not_ported("precision 'high'")
    if precision is Precision.DEFAULT and x.dtype != torch.bfloat16:
        raise TypeError("the DEFAULT pass takes a bf16 plane")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dct2_pass takes f32 or bf16, not {x.dtype}")
    c = basis_tensor(x.shape[axis], x.device, x.dtype, ortho=ortho)
    bf16_out = x.dtype == torch.bfloat16 and out_dtype == torch.bfloat16
    mm = matmul_bf16 if bf16_out else matmul_f32
    if axis in (-2, x.ndim - 2):
        out = mm(c, x)                      # out[k, w] = sum_h C[k, h] x[h, w]
    elif axis in (-1, x.ndim - 1):
        out = mm(x, c.t())                  # out[h, l] = sum_w x[h, w] C[l, w]
    else:
        raise ValueError("axis must be one of the last two axes")
    return out if out_dtype is None else out.to(out_dtype)


def _rows_cols(idx: torch.Tensor, w: int):
    return torch.div(idx, w, rounding_mode="floor"), idx % w


def _dot_rows(t: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
              ch: torch.Tensor, cw: torch.Tensor,
              contracted_axis: int) -> torch.Tensor:
    """coeff[r, c] from a plane after one pass: the one row (or column) of
    ``t`` it needs against the basis row at the other coordinate; products
    and sums in f32."""
    h, w = t.shape[-2], t.shape[-1]
    if contracted_axis in (-2, t.ndim - 2):
        # t = C_h @ Y; coeff[r, c] = t[r, :] . C_w[c, :]
        g = torch.gather(t, -2, rows[..., None].expand(*rows.shape, w))
        cg = cw[cols]
    elif contracted_axis in (-1, t.ndim - 1):
        # t = Y @ C_w^T; coeff[r, c] = C_h[r, :] . t[:, c]
        g = torch.gather(t, -1, cols[..., None, :].expand(
            *cols.shape[:-1], h, cols.shape[-1])).transpose(-1, -2)
        cg = ch[rows]
    else:
        raise ValueError("contracted_axis must be one of the last two axes")
    return (g.to(torch.float32) * cg.to(torch.float32)).sum(-1)


def dct2_dot_at(t: torch.Tensor, idx: torch.Tensor, *, contracted_axis: int,
                precision: Precision = Precision.HIGHEST) -> torch.Tensor:
    """Finish a 2-D DCT at flat indices ``idx`` (..., n), given one pass.

    ``t`` (..., H, W) is the plane after :func:`dct2_pass` over
    ``contracted_axis``. For each ``i = r*W + c`` this returns coeff[r, c]
    as n dots of length W (or H). At DEFAULT the operands are bf16 (exact
    products, f32 sums; the JAX DEFAULT branch computes the same dots as a
    masked matmul, so only the summation order differs); at HIGHEST they
    are f32, the JAX gather-dot branch.
    """
    if precision is Precision.HIGH:
        raise _not_ported("precision 'high'")
    if t.ndim != idx.ndim + 1:
        idx = idx.expand(*t.shape[:-2], idx.shape[-1])
    h, w = t.shape[-2], t.shape[-1]
    dtype = torch.bfloat16 if precision is Precision.DEFAULT else torch.float32
    rows, cols = _rows_cols(idx, w)
    return _dot_rows(t.to(dtype), rows, cols,
                     basis_tensor(h, t.device, dtype),
                     basis_tensor(w, t.device, dtype), contracted_axis)


def dct2_coeffs_at(y: torch.Tensor, idx: torch.Tensor, *, ortho: bool = False,
                   precision: Precision = Precision.HIGHEST) -> torch.Tensor:
    """DCT-II coefficients of ``y`` (..., H, W) at flat indices ``idx``
    (..., n) only: one full f32 pass over the shorter axis, then the
    gather-dot at the n positions (the read path needs the derived image's
    coefficients only there, reference src/algorithm.rs:543-562)."""
    if precision is not Precision.HIGHEST:
        raise _not_ported(f"dct2_coeffs_at at precision {precision.value!r}")
    h, w = y.shape[-2], y.shape[-1]
    ch = basis_tensor(h, y.device, torch.float32, ortho=ortho)
    cw = basis_tensor(w, y.device, torch.float32, ortho=ortho)
    rows, cols = _rows_cols(idx, w)
    if h <= w:
        return _dot_rows(matmul_f32(ch, y), rows, cols, ch, cw, -2)
    return _dot_rows(matmul_f32(y, cw.t()), rows, cols, ch, cw, -1)
