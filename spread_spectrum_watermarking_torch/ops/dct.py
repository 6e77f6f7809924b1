"""DCT-II bases, the 2-D transforms and the 1-D passes, in PyTorch.

Port of the JAX package's ``ops/dct.py`` at its three tiers. The numpy
basis builders are copied verbatim, so both packages transform with
bit-identical bases (scipy scaling, reference src/dct2d.rs:105-118). Every
product goes through :func:`matmul`, which says what each tier computes:

- ``Precision.HIGHEST``: full f32, TF32 off (:func:`matmul_f32`). The
  whole-image transforms :func:`dct2_2d` and :func:`idct2_2d` are kernels
  K6a/K6b on a CUDA tensor (``..kernels.dct2d_fused``), their plain
  versions on the CPU.
- ``Precision.HIGH``: bf16x3 (:func:`matmul_bf16x3`), the split the TPU's
  matrix unit runs for this tier: each f32 operand becomes a bf16 ``hi``
  and a bf16 ``lo`` part, and ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` is
  summed in f32.
- ``Precision.DEFAULT``: bf16 operands, f32 sums. A bf16 result is
  ``torch.matmul`` on bf16 tensors with cuBLAS's reduced-precision
  reduction turned off (:func:`matmul_bf16`): by default cuBLAS may add
  split-K partial sums in bf16.

At DEFAULT and HIGH the dense 2-D transforms are these plain products on
every device, as the JAX package leaves them to XLA. ``fold=True`` takes
the folded transforms under the JAX package's condition (H and W even,
``min(H, W) >= 64``; otherwise the dense form): at DEFAULT and HIGH the
forward transform's two folded passes are kernel K1f on a CUDA tensor
(``..kernels.fold_pass``) and their plain versions, :func:`_fold_pass_rows`
and :func:`_fold_pass_cols`, on the CPU; at HIGHEST, and for the inverse
at every tier, the fold is plain products on every device.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..config import Precision
from ..kernels import dct2d_fused, fold_pass


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


def _bf16_values(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (RNE), held in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16x3 split of ``x``: ``hi = bf16(x)`` and ``lo = bf16(x - hi)``,
    both held in f32 (the subtraction is exact)."""
    x = x.to(torch.float32)
    hi = _bf16_values(x)
    return hi, _bf16_values(x - hi)


def _bf16x3_operands(a: torch.Tensor, b: torch.Tensor, a_dim: int,
                     b_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``[a_hi, a_hi, a_lo]`` and ``[b_hi, b_lo, b_hi]`` (:func:`split_bf16`),
    concatenated along the contracted dims: contracting them is the sum
    ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` as one sum of 3K terms.
    ``a_lo b_lo`` is dropped, as the TPU drops it."""
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    return (torch.cat([a_hi, a_hi, a_lo], dim=a_dim),
            torch.cat([b_hi, b_lo, b_hi], dim=b_dim))


def matmul_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at the HIGH tier, f32 out: the three products of the
    bf16 parts (:func:`_bf16x3_operands`), exact, summed in f32."""
    return matmul_f32(*_bf16x3_operands(a, b, -1, -2))


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: Precision) -> torch.Tensor:
    """``a @ b`` in f32 at a tier: f32 (HIGHEST), bf16x3 (HIGH), or bf16
    operands with f32 sums (DEFAULT)."""
    if precision is Precision.HIGHEST:
        return matmul_f32(a, b)
    if precision is Precision.HIGH:
        return matmul_bf16x3(a, b)
    return matmul_f32(_bf16_values(a), _bf16_values(b))


def shorter_axis(h: int, w: int) -> int:
    """The axis the first pass contracts: the shorter one, the cheaper full
    pass (the JAX package's ``pipeline._shorter_axis``)."""
    return -2 if h <= w else -1


def _fold_pass_rows(x: torch.Tensor, c_full: torch.Tensor,
                    precision: Precision) -> torch.Tensor:
    """One DCT-II pass contracting the -2 axis, with even/odd folding (the
    JAX package's ``dct._fold_pass_rows``).

    The symmetry ``C[k, N-1-m] = (-1)^k C[k, m]``: even output rows contract
    ``s = x[m] + x[N-1-m]``, odd rows ``d = x[m] - x[N-1-m]``, each against
    an (N/2, N/2) half of the basis, half the operations of the dense pass.
    ``s`` and ``d`` are formed in f32 first; the products round them to the
    tier (:func:`matmul`). Rows ``2q`` and ``2q+1`` take the q-th rows of
    the two products.
    """
    n = x.shape[-2]
    half = n // 2
    a = x[..., :half, :]
    b = torch.flip(x[..., half:, :], dims=(-2,))
    te = matmul(c_full[0::2, :half], a + b, precision)
    to = matmul(c_full[1::2, :half], a - b, precision)
    return torch.stack([te, to], dim=-2).reshape(*x.shape[:-2], n,
                                                 x.shape[-1])


def _fold_pass_cols(x: torch.Tensor, c_full: torch.Tensor,
                    precision: Precision) -> torch.Tensor:
    """:func:`_fold_pass_rows` contracting the last axis (the JAX package's
    ``dct._fold_pass_cols``)."""
    n = x.shape[-1]
    half = n // 2
    a = x[..., :half]
    b = torch.flip(x[..., half:], dims=(-1,))
    ue = matmul(a + b, c_full[0::2, :half].t(), precision)
    uo = matmul(a - b, c_full[1::2, :half].t(), precision)
    return torch.stack([ue, uo], dim=-1).reshape(*x.shape[:-1], n)


def _ifold_pass_rows(x: torch.Tensor, d_full: torch.Tensor,
                     precision: Precision) -> torch.Tensor:
    """Folded DCT-III pass over the -2 axis (the JAX package's
    ``dct._ifold_pass_rows``): with ``D[N-1-k, m] = (-1)^m D[k, m]``, the
    top half of the output is ``E + O`` and the bottom half the reversed
    ``E - O``, E and O contracting the even and the odd input rows, each
    sum formed in f32 after both products."""
    half = x.shape[-2] // 2
    e = matmul(d_full[:half, 0::2], x[..., 0::2, :], precision)
    o = matmul(d_full[:half, 1::2], x[..., 1::2, :], precision)
    return torch.cat([e + o, torch.flip(e - o, dims=(-2,))], dim=-2)


def _ifold_pass_cols(x: torch.Tensor, d_full: torch.Tensor,
                     precision: Precision) -> torch.Tensor:
    """Folded DCT-III pass over the last axis (``dct._ifold_pass_cols``)."""
    half = x.shape[-1] // 2
    e = matmul(x[..., 0::2], d_full[:half, 0::2].t(), precision)
    o = matmul(x[..., 1::2], d_full[:half, 1::2].t(), precision)
    return torch.cat([e + o, torch.flip(e - o, dims=(-1,))], dim=-1)


def _folds(h: int, w: int, fold: bool) -> bool:
    """The JAX package's condition for the folded transforms."""
    return fold and h % 2 == 0 and w % 2 == 0 and min(h, w) >= 64


def dct2_2d(x: torch.Tensor, *, ortho: bool = False,
            precision: Precision = Precision.HIGHEST,
            fold: bool = False) -> torch.Tensor:
    """2-D DCT-II over the last two axes (..., H, W) of an f32 ``x``, scipy
    scaling: ``(C_h @ X) @ C_w^T``, in the JAX package's association.

    HIGHEST: a CUDA tensor runs kernel K6a, a CPU tensor its plain version.
    DEFAULT and HIGH: two :func:`matmul` products at the tier (at DEFAULT
    the f32 intermediate is rounded to bf16 as the second operand).
    ``fold`` (where :func:`_folds`): the rows pass, then the cols pass, each
    folded: kernel K1f at DEFAULT and HIGH on a CUDA tensor, plain products
    at HIGHEST and on the CPU.
    """
    h, w = x.shape[-2], x.shape[-1]
    folds = _folds(h, w, fold)
    if (folds and precision is not Precision.HIGHEST
            and x.device.type != "cpu"):
        t = fold_pass.fold_pass(x.contiguous(), -2, ortho, precision)
        return fold_pass.fold_pass(t, -1, ortho, precision)
    if precision is Precision.HIGHEST and not folds:
        return dct2d_fused.dct2_2d_fused(x.contiguous(), ortho=ortho)
    ch = basis_tensor(h, x.device, torch.float32, ortho=ortho)
    cw = basis_tensor(w, x.device, torch.float32, ortho=ortho)
    if folds:  # the plain folded passes (K1f's plain version on the CPU)
        return _fold_pass_cols(_fold_pass_rows(x, ch, precision), cw,
                               precision)
    return matmul(matmul(ch, x, precision), cw.t(), precision)


def idct2_2d(x: torch.Tensor, *, precision: Precision = Precision.HIGHEST,
             fold: bool = False) -> torch.Tensor:
    """Inverse of :func:`dct2_2d` (non-ortho): ``(D_h @ X) @ D_w^T`` times
    ``f32(4/(W*H))``. HIGHEST: a CUDA tensor runs kernel K6b, a CPU tensor
    its plain version; DEFAULT and HIGH: :func:`matmul` at the tier.
    ``fold`` (where :func:`_folds`): the two folded passes as plain products
    at the tier on every device, then the scale."""
    h, w = x.shape[-2], x.shape[-1]
    folds = _folds(h, w, fold)
    if precision is Precision.HIGHEST and not folds:
        return dct2d_fused.idct2_2d_fused(x.contiguous())
    dh = basis_tensor(h, x.device, torch.float32, inverse=True)
    dw = basis_tensor(w, x.device, torch.float32, inverse=True)
    if folds:
        y = _ifold_pass_cols(_ifold_pass_rows(x, dh, precision), dw,
                             precision)
    else:
        y = matmul(matmul(dh, x, precision), dw.t(), precision)
    return y * dct2d_fused.inverse_scale(h, w)


def dct2_pass(x: torch.Tensor, *, axis: int, ortho: bool = False,
              precision: Precision = Precision.HIGHEST,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One 1-D DCT-II pass along ``axis`` (-1 or -2), scipy scaling.

    The basis takes ``x``'s dtype (f32 or bf16), as in the JAX package, and
    the product is the tier's (:func:`matmul`; products of bf16 values are
    exact). The result is f32, or ``out_dtype``, rounded once from the f32
    sum. ``Precision.DEFAULT`` takes only bf16 planes.
    """
    if precision is Precision.DEFAULT and x.dtype != torch.bfloat16:
        raise TypeError("the DEFAULT pass takes a bf16 plane")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dct2_pass takes f32 or bf16, not {x.dtype}")
    c = basis_tensor(x.shape[axis], x.device, x.dtype, ortho=ortho)
    if x.dtype == torch.bfloat16 and out_dtype == torch.bfloat16:
        mm = matmul_bf16
    else:
        def mm(a, b):
            return matmul(a, b, precision)
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
              ch: torch.Tensor, cw: torch.Tensor, contracted_axis: int,
              precision: Precision) -> torch.Tensor:
    """coeff[r, c] from a plane after one pass: the one row (or column) of
    ``t`` it needs against the basis row at the other coordinate, products
    at the tier (bf16 operands at DEFAULT, the bf16x3 split at HIGH) and
    sums in f32."""
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
    if precision is Precision.DEFAULT:
        g, cg = _bf16_values(g), _bf16_values(cg)
    elif precision is Precision.HIGH:
        g, cg = _bf16x3_operands(g, cg, -1, -1)
    return (g.to(torch.float32) * cg.to(torch.float32)).sum(-1)


def dct2_dot_at(t: torch.Tensor, idx: torch.Tensor, *, contracted_axis: int,
                precision: Precision = Precision.HIGHEST) -> torch.Tensor:
    """Finish a 2-D DCT at flat indices ``idx`` (..., n), given one pass.

    ``t`` (..., H, W) is the plane after :func:`dct2_pass` over
    ``contracted_axis``. For each ``i = r*W + c`` this returns coeff[r, c]
    as n dots of length W (or H), products at the tier and f32 sums. The
    JAX package's DEFAULT and HIGH branches compute the same dots as a
    masked matmul against f32 (HIGH) or bf16 (DEFAULT) basis columns, so
    only the summation order differs; at HIGHEST it is the same gather-dot.
    """
    if t.ndim != idx.ndim + 1:
        idx = idx.expand(*t.shape[:-2], idx.shape[-1])
    h, w = t.shape[-2], t.shape[-1]
    rows, cols = _rows_cols(idx, w)
    # At DEFAULT the bf16 bases are the bf16-rounded f32 ones.
    dtype = torch.bfloat16 if precision is Precision.DEFAULT else torch.float32
    return _dot_rows(t, rows, cols, basis_tensor(h, t.device, dtype),
                     basis_tensor(w, t.device, dtype), contracted_axis,
                     precision)


def dct2_coeffs_at(y: torch.Tensor, idx: torch.Tensor, *, ortho: bool = False,
                   precision: Precision = Precision.HIGHEST) -> torch.Tensor:
    """DCT-II coefficients of ``y`` (..., H, W) at flat indices ``idx``
    (..., n) only: one full pass over the shorter axis, then the gather-dot
    at the n positions, both at the tier (the read path needs the derived
    image's coefficients only there, reference src/algorithm.rs:543-562)."""
    h, w = y.shape[-2], y.shape[-1]
    ch = basis_tensor(h, y.device, torch.float32, ortho=ortho)
    cw = basis_tensor(w, y.device, torch.float32, ortho=ortho)
    rows, cols = _rows_cols(idx, w)
    if h <= w:
        return _dot_rows(matmul(ch, y, precision), rows, cols, ch, cw, -2,
                         precision)
    return _dot_rows(matmul(y, cw.t(), precision), rows, cols, ch, cw, -1,
                     precision)


def sparse_factors_f32(delta: torch.Tensor, idx: torch.Tensor, h: int,
                       w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k-major f32 factors of the sparse inverse of updates ``delta``
    at flat indices ``idx`` (..., n), dY = (4/(W*H)) D_h[:, rows]
    diag(delta) D_w[:, cols]^T, without the scale: ``D_h[:, rows] * delta``
    as (..., n, H) and ``D_w[:, cols]`` as (..., n, W)."""
    rows, cols = _rows_cols(idx, w)
    dh = basis_tensor(h, delta.device, torch.float32, inverse=True)
    dw = basis_tensor(w, delta.device, torch.float32, inverse=True)
    return dh.t()[rows] * delta[..., None], dw.t()[cols]


def sparse_idct_factors(delta: torch.Tensor, idx: torch.Tensor, h: int,
                        w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The DEFAULT tier's k-major bf16 factors (kernel K4's operands): the
    scale folded into ``a`` before the bf16 rounding, as the JAX DEFAULT
    branch rounds them."""
    a, b = sparse_factors_f32(delta, idx, h, w)
    return ((a * dct2d_fused.inverse_scale(h, w)).to(torch.bfloat16),
            b.to(torch.bfloat16))
