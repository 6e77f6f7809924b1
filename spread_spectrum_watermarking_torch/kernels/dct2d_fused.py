"""K6a/K6b: the whole-image 2-D DCT-II and its inverse, f32 (``HIGHEST``).

Replace the TPU kernels ``dct2_2d_fused`` and ``idct2_2d_fused``
(``ops/dct_pallas.py`` of the JAX package at fa94855, ``pallas_call`` at
:58 and :97). The CUDA source, ``csrc/dct2d_fused.cu``, says what bounds
them on the H100 and how its design answers that. Both compute, per image,
``s * ((L @ X) @ R^T)`` in the JAX package's association; the plain
versions, :func:`dct2_2d_fused_reference` and
:func:`idct2_2d_fused_reference`, are two f32 ``torch.matmul`` calls with
TF32 off: the CPU path, and what the kernels are held against on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import dct
from . import _build

#: Launches of the CUDA kernel in this process, K6a and K6b (plain-version
#: calls excluded).
FORWARD_LAUNCHES = 0
INVERSE_LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P]


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


def _launch(x: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
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
    if batch > 65535:  # the grid's y dimension
        raise ValueError(f"at most 65535 images a call, got {batch}")
    out = torch.empty_like(x)
    work = torch.empty_like(x)  # the first pass, L @ X
    fn = _build.kernel("ssw_dct2d_fused", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), left.data_ptr(), right.data_ptr(),
                  work.data_ptr(), out.data_ptr(), batch, h, w,
                  scale, stream)
    _build.check(code, "ssw_dct2d_fused")
    return out


def dct2_2d_fused(x: torch.Tensor, ortho: bool = False) -> torch.Tensor:
    """K6a: (..., H, W) f32 -> its 2-D DCT-II ``(C_h @ X) @ C_w^T``, f32.

    CPU tensors take :func:`dct2_2d_fused_reference`; CUDA tensors launch
    the kernel or raise.
    """
    if x.device.type == "cpu":
        return dct2_2d_fused_reference(x, ortho)
    out = _launch(x, *_bases(x, False, ortho), 1.0)
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
    out = _launch(x, *_bases(x, True),
                  inverse_scale(x.shape[-2], x.shape[-1]))
    global INVERSE_LAUNCHES
    INVERSE_LAUNCHES += 1
    return out
