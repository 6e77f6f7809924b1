"""K6a/K6b: the whole-image 2-D DCT-II and its inverse, f32 (``HIGHEST``).

Replace the TPU kernels ``dct2_2d_fused`` and ``idct2_2d_fused``
(``ops/dct_pallas.py`` of the JAX package at fa94855, ``pallas_call`` at
:58 and :97). The CUDA source, ``csrc/dct2d_fused.cu``, says what bounds
them on the H100 and how its design answers that. Both compute, per image,
``s * ((L @ X) @ R^T)`` in the JAX package's association, as 3xTF32
products on the tensor cores: each f32 operand split into two TF32 parts
(:func:`split_tf32`) and three products of the parts summed in f32.

The plain versions, :func:`dct2_2d_fused_reference` and
:func:`idct2_2d_fused_reference`, are two f32 ``torch.matmul`` calls with
TF32 off: the CPU path, and what the kernels are held against on the card,
within :func:`k6_bound`. :func:`dct2_2d_tf32x3_reference` and
:func:`idct2_2d_tf32x3_reference` emulate the kernels' split in plain
PyTorch for the CPU tests; nothing on the main path calls them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import dct
from . import _build

#: Launches of the CUDA kernels in this process, K6a and K6b, one per call
#: (each call runs its two passes; plain-version calls excluded).
FORWARD_LAUNCHES = 0
INVERSE_LAUNCHES = 0

#: The TF32 split's share of K6's tolerance, in units of
#: ``2^-24 |L| |X| |R|^T``: each product of a pass within ``12 (1 + 2^-10)``
#: of ``|a| |b|`` (``csrc/dct2d_fused.cu`` derives it), two passes, rounded
#: up.
SPLIT_TERMS = 25
_U = 2.0 ** -24

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P]
_MAX_GRID_YZ = 65535  # the grid's y (tiles of 128) and z (images) limit


def inverse_scale(h: int, w: int) -> float:
    """The inverse's global factor, ``f32(4/(W*H))``, applied once after the
    second sum (reference src/dct2d.rs:213-218)."""
    return float(np.float32(4.0 / (w * h)))


def _bases(x: torch.Tensor, inverse: bool, ortho: bool = False):
    h, w = x.shape[-2], x.shape[-1]
    return (dct.basis_tensor(h, x.device, torch.float32, inverse, ortho),
            dct.basis_tensor(w, x.device, torch.float32, inverse, ortho))


def dct2_2d_fused_reference(x: torch.Tensor, ortho: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`dct2_2d_fused`."""
    ch, cw = _bases(x, False, ortho)
    return dct.matmul_f32(dct.matmul_f32(ch, x), cw.t())


def idct2_2d_fused_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`idct2_2d_fused`."""
    dh, dw = _bases(x, True)
    y = dct.matmul_f32(dct.matmul_f32(dh, x), dw.t())
    return y * inverse_scale(x.shape[-2], x.shape[-1])


def abs_transform(x: torch.Tensor, inverse: bool = False,
                  ortho: bool = False) -> torch.Tensor:
    """``s |L| |X| |R|^T``: the scale of the f32 sums of a 2-D transform of
    ``x`` (``s`` the inverse's scale, or 1)."""
    h, w = x.shape[-2], x.shape[-1]
    left, right = (b.abs() for b in _bases(x, inverse, ortho))
    scale = inverse_scale(h, w) if inverse else 1.0
    return scale * dct.matmul_f32(dct.matmul_f32(left, x.abs()), right.t())


def k6_bound(x: torch.Tensor, inverse: bool = False,
             ortho: bool = False) -> torch.Tensor:
    """K6a's (K6b's) tolerance against its plain version, per element:
    ``(2 (H + W) + SPLIT_TERMS + [inverse]) 2^-24 s |L| |X| |R|^T``, the
    two f32 sums in another order, the TF32 split, and one more rounding
    for K6b's scale."""
    h, w = x.shape[-2], x.shape[-1]
    terms = 2 * (h + w) + SPLIT_TERMS + int(inverse)
    return terms * _U * abs_transform(x, inverse, ortho)


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 explicit mantissa bits), ties away from
    zero, with the 13 low bits cleared: ``cvt.rna.tf32.f32`` for finite
    values and infinities."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of ``x``: ``hi = rna(x)``, ``lo = rna(x - hi)``,
    both f32 with TF32 values (the subtraction is exact)."""
    x = x.to(torch.float32)
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)


def _matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` from the TF32 parts, as the kernels sum them: the small
    products ``lo_a hi_b + hi_a lo_b`` first, then ``hi_a hi_b``, each an
    f32 product of TF32 values (exact products, f32 sums)."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    small = dct.matmul_f32(a_lo, b_hi) + dct.matmul_f32(a_hi, b_lo)
    return small + dct.matmul_f32(a_hi, b_hi)


def dct2_2d_tf32x3_reference(x: torch.Tensor, ortho: bool = False
                             ) -> torch.Tensor:
    """Plain PyTorch emulation of K6a's 3xTF32 arithmetic (not its sum
    order): both passes from split operands."""
    ch, cw = _bases(x, False, ortho)
    return _matmul_tf32x3(_matmul_tf32x3(ch, x), cw.t())


def idct2_2d_tf32x3_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch emulation of K6b's 3xTF32 arithmetic, then the scale."""
    dh, dw = _bases(x, True)
    y = _matmul_tf32x3(_matmul_tf32x3(dh, x), dw.t())
    return y * inverse_scale(x.shape[-2], x.shape[-1])


@functools.lru_cache(maxsize=16)
def _basis_parts(n: int, device: torch.device, inverse: bool, ortho: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The TF32 parts of an f32 basis on ``device``, split once."""
    return split_tf32(dct.basis_tensor(n, device, torch.float32, inverse,
                                       ortho))


def _launch(x: torch.Tensor, inverse: bool, ortho: bool,
            scale: float) -> torch.Tensor:
    if x.dtype != torch.float32 or x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (..., H, W) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"the 2-D DCT kernels run on CPU or CUDA, not {x.device}")
    h, w = x.shape[-2], x.shape[-1]
    batch = x.numel() // (h * w)
    if batch > _MAX_GRID_YZ:
        raise ValueError(f"at most {_MAX_GRID_YZ} images a call, got {batch}")
    if -(-max(h, w) // 128) > _MAX_GRID_YZ:  # tiles of 128 along H or W
        raise ValueError(f"at most {_MAX_GRID_YZ * 128} rows and columns, got "
                         f"{h} x {w}")
    l_hi, l_lo = _basis_parts(h, x.device, inverse, ortho)
    r_hi, r_lo = _basis_parts(w, x.device, inverse, ortho)
    out = torch.empty_like(x)
    work = torch.empty_like(x)  # the first pass, L @ X
    fn = _build.kernel("ssw_dct2d_fused", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), l_hi.data_ptr(), l_lo.data_ptr(),
                  r_hi.data_ptr(), r_lo.data_ptr(), work.data_ptr(),
                  out.data_ptr(), batch, h, w, scale, stream)
    _build.check(code, "ssw_dct2d_fused")
    return out


def dct2_2d_fused(x: torch.Tensor, ortho: bool = False) -> torch.Tensor:
    """K6a: (..., H, W) f32 -> its 2-D DCT-II ``(C_h @ X) @ C_w^T``, f32.

    CPU tensors take :func:`dct2_2d_fused_reference`; CUDA tensors launch
    the kernel or raise.
    """
    if x.device.type == "cpu":
        return dct2_2d_fused_reference(x, ortho)
    out = _launch(x, False, ortho, 1.0)
    global FORWARD_LAUNCHES
    FORWARD_LAUNCHES += 1
    return out


def idct2_2d_fused(x: torch.Tensor) -> torch.Tensor:
    """K6b: (..., H, W) f32 -> ``f32(4/(W*H)) * ((D_h @ X) @ D_w^T)``, f32.

    CPU tensors take :func:`idct2_2d_fused_reference`; CUDA tensors launch
    the kernel or raise.
    """
    if x.device.type == "cpu":
        return idct2_2d_fused_reference(x)
    out = _launch(x, True, False, inverse_scale(x.shape[-2], x.shape[-1]))
    global INVERSE_LAUNCHES
    INVERSE_LAUNCHES += 1
    return out
