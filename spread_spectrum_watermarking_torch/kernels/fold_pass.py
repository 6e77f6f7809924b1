"""K1f: one folded DCT-II pass of an f32 plane, at DEFAULT or HIGH.

Replaces the TPU kernel ``luma_fold_row_pass`` (``ops/fused_dct.py`` of the
JAX package at 257c497, ``pallas_call`` at :277). The CUDA source,
``csrc/fold_pass.cu``, says what bounds it on the H100 and how its design
answers that. :func:`fold_pass_reference` is its plain version, the JAX
package's ``dct._fold_pass_rows``/``_fold_pass_cols`` at the tier
(``ops.dct``): the CPU path, and what the kernel is held against on the
card. ``ops.dct.dct2_2d(fold=True)`` runs it for both forward passes at
DEFAULT and HIGH; at HIGHEST, and for the inverse, the fold stays plain
products, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import Precision
from ..ops import dct
from . import _build, _tiles

#: Launches of the CUDA kernel at DEFAULT and at HIGH in this process
#: (plain-version calls excluded).
LAUNCHES = 0
HIGH_LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _P]


def _check_mode(axis: int, precision: Precision) -> None:
    if precision is Precision.HIGHEST:
        raise ValueError("fold_pass runs at DEFAULT or HIGH, not HIGHEST")
    if axis not in (-2, -1):
        raise ValueError(f"axis must be -2 or -1, got {axis}")


def fold_pass_reference(x: torch.Tensor, axis: int, ortho: bool = False,
                        precision: Precision = Precision.DEFAULT
                        ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fold_pass`."""
    _check_mode(axis, precision)
    c = dct.basis_tensor(x.shape[axis], x.device, torch.float32, ortho=ortho)
    fold = dct._fold_pass_rows if axis == -2 else dct._fold_pass_cols
    return fold(x, c, precision)


def _fold_products(x: torch.Tensor, axis: int, precision: Precision,
                   product) -> torch.Tensor:
    """``product(left, right)`` of each parity's operands as the kernel
    multiplies them (bf16 values at DEFAULT; at HIGH the hi/lo parts of the
    three products, concatenated along k), in true order."""
    n = x.shape[axis]
    half = n // 2
    xr = x if axis == -2 else x.transpose(-1, -2)
    a, b = xr[..., :half, :], torch.flip(xr[..., half:, :], dims=(-2,))
    c = dct.basis_tensor(n, x.device, torch.float32)
    outs = []
    for cp, v in ((c[0::2, :half], a + b), (c[1::2, :half], a - b)):
        if precision is Precision.HIGH:
            left, right = dct._bf16x3_operands(cp, v, -1, -2)
        else:
            left, right = dct._bf16_values(cp), dct._bf16_values(v)
        outs.append(product(left, right))
    t = torch.stack(outs, dim=-2).reshape(xr.shape)
    return t if axis == -2 else t.transpose(-1, -2)


def fold_terms(x: torch.Tensor, axis: int,
               precision: Precision = Precision.DEFAULT) -> torch.Tensor:
    """``sum_m |c_p[q, m]| |v_p[m]|`` for each output of :func:`fold_pass`,
    over the operands its products take (bf16 values at DEFAULT; the hi/lo
    parts of the three products at HIGH), in true order: the scale of its
    f32 sums, so the kernel is within ``2 K 2^-24 fold_terms`` of its plain
    version (K = N/2 terms, 3N/2 at HIGH)."""
    _check_mode(axis, precision)
    return _fold_products(x, axis, precision,
                          lambda a, b: dct.matmul_f32(a.abs(), b.abs()))


def f64_error(out: torch.Tensor, x: torch.Tensor, axis: int,
              precision: Precision = Precision.DEFAULT) -> float:
    """The largest error of ``out`` (:func:`fold_pass` of ``x``, or its
    plain version's) against the f64 product of the same operands, in
    units of ``2^-24 fold_terms``: the error of its f32 sums alone."""
    _check_mode(axis, precision)
    exact = _fold_products(x, axis, precision,
                           lambda a, b: torch.matmul(a.double(), b.double()))
    unit = 2.0 ** -24 * fold_terms(x, axis, precision).double()
    return float(((out.double() - exact).abs() / unit.clamp_min(1e-300))
                 .max())


@functools.lru_cache(maxsize=16)
def _fold_bases(n: int, ortho: bool, device: torch.device,
                precision: Precision) -> torch.Tensor:
    """The tile image (``_tiles.tile_image``) of the halves
    ``ce = C[0::2, :n/2]`` and ``co = C[1::2, :n/2]`` of the f32 DCT-II
    basis of size n, as (2, parts, rt, kt, 128, 64) bf16: one part,
    ``bf16(.)``, at DEFAULT; the ``hi`` and ``lo`` parts of
    ``dct.split_bf16`` at HIGH: the parts the plain products form."""
    half = n // 2
    c = dct.basis_tensor(n, device, torch.float32, ortho=ortho)
    halves = torch.stack([c[0::2, :half], c[1::2, :half]])
    parts = (dct.split_bf16(halves) if precision is Precision.HIGH
             else (halves,))
    return _tiles.tile_image(torch.stack(parts, dim=1))


def _work_elems(b: int, h: int, w: int, axis: int,
                precision: Precision) -> int:
    """bf16 elements of the fold's tile image: s and d, rows along the
    other axis, k along half the contracted one, two parts at HIGH."""
    n, other = (h, w) if axis == -2 else (w, h)
    rt, kt = _tiles.tile_counts(other, n // 2)
    parts = 2 if precision is Precision.HIGH else 1
    return b * 2 * parts * rt * kt * _tiles.ROWS * _tiles.DEPTH


def fold_pass(x: torch.Tensor, axis: int, ortho: bool = False,
              precision: Precision = Precision.DEFAULT) -> torch.Tensor:
    """(..., H, W) f32 -> the folded DCT-II pass over ``axis`` (-2 or -1,
    whose length must be even), f32 in true order, at ``precision``
    (DEFAULT or HIGH).

    CPU tensors take :func:`fold_pass_reference`; CUDA tensors launch the
    kernel or raise.
    """
    _check_mode(axis, precision)
    if x.device.type == "cpu":
        return fold_pass_reference(x, axis, ortho, precision)
    if x.dtype != torch.float32 or x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (..., H, W) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"fold_pass runs on CPU or CUDA, not {x.device}")
    h, w = x.shape[-2], x.shape[-1]
    n = x.shape[axis]
    if n % 2:
        raise ValueError(f"the folded pass needs an even length, got {n}")
    batch = x.numel() // (h * w)
    if batch > 65535:  # the grid's z dimension
        raise ValueError(f"at most 65535 planes a call, got {batch}")
    basis = _fold_bases(n, ortho, x.device, precision)
    n_work = _work_elems(batch, h, w, axis, precision)
    work = torch.empty(n_work, dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    fn = _build.kernel("ssw_fold_pass", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), basis.data_ptr(), work.data_ptr(), n_work,
                  out.data_ptr(), batch, h, w, int(axis == -2),
                  int(precision is Precision.HIGH), stream)
    _build.check(code, "ssw_fold_pass")
    global LAUNCHES, HIGH_LAUNCHES
    if precision is Precision.HIGH:
        HIGH_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
