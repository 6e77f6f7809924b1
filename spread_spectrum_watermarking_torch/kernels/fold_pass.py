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
from . import _build

#: Launches of the CUDA kernel at DEFAULT and at HIGH in this process
#: (plain-version calls excluded).
LAUNCHES = 0
HIGH_LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_BK = 32  # the kernel's k-step (csrc/tile_gemm.cuh BK): the bases' row pitch


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


def fold_terms(x: torch.Tensor, axis: int,
               precision: Precision = Precision.DEFAULT) -> torch.Tensor:
    """``sum_m |c_p[q, m]| |v_p[m]|`` for each output of :func:`fold_pass`,
    over the operands its products take (bf16 values at DEFAULT; the hi/lo
    parts of the three products at HIGH), in true order: the scale of its
    f32 sums, so the kernel is within ``2 K 2^-24 fold_terms`` of its plain
    version (K = N/2 terms, 3N/2 at HIGH)."""
    _check_mode(axis, precision)
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
        outs.append(dct.matmul_f32(left.abs(), right.abs()))
    t = torch.stack(outs, dim=-2).reshape(xr.shape)
    return t if axis == -2 else t.transpose(-1, -2)


@functools.lru_cache(maxsize=16)
def _fold_bases(n: int, ortho: bool, device: torch.device,
                precision: Precision) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The halves ``ce = C[0::2, :n/2]`` and ``co = C[1::2, :n/2]`` of the
    f32 DCT-II basis of size n, as (2, n/2, pitch) bf16 with the rows
    zero-padded to a multiple of 32: ``bf16(.)`` at DEFAULT (and None), the
    ``hi`` and ``lo`` parts of ``dct.split_bf16`` at HIGH, the parts the
    plain products form."""
    half = n // 2
    c = dct.basis_tensor(n, device, torch.float32, ortho=ortho)
    hi, lo = dct.split_bf16(torch.stack([c[0::2, :half], c[1::2, :half]]))
    pitch = -(-half // _BK) * _BK

    def padded(t):
        return torch.nn.functional.pad(t, (0, pitch - half)).to(
            torch.bfloat16).contiguous()
    return padded(hi), padded(lo) if precision is Precision.HIGH else None


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
    hi, lo = _fold_bases(n, ortho, x.device, precision)
    out = torch.empty_like(x)
    fn = _build.kernel("ssw_fold_pass", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), hi.data_ptr(),
                  None if lo is None else lo.data_ptr(), out.data_ptr(),
                  batch, h, w, hi.shape[-1], int(axis == -2), stream)
    _build.check(code, "ssw_fold_pass")
    global LAUNCHES, HIGH_LAUNCHES
    if precision is Precision.HIGH:
        HIGH_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
