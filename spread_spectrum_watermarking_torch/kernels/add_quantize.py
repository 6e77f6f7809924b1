"""K7: u8 RGB + luma delta, rounded once and clamped, f32 or quantized u8.

The HIGHEST sparse embed's epilogue, fused. It replaces no TPU kernel: the
JAX package leaves ``clip(u8_to_f32(rgb) + dy[..., None], 0, 1)`` and
``f32_to_u8`` (``models/pipeline.py:435,443``) to XLA, which contracts
``u8 * f32(1/255) + dy`` into one FMA. The CUDA source,
``csrc/add_quantize.cu``, says what bounds it on the H100 and how its
design answers that. :func:`add_quantize_reference` is its plain version,
bit-equal to jitted JAX: the CPU path, and what the kernel is held against
(bit for bit) on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import colorspace
from . import _build

#: Launches of the CUDA kernel in this process (plain-version calls excluded).
LAUNCHES = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]


def add_quantize_reference(rgb: torch.Tensor, dy: torch.Tensor,
                           quantize: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`add_quantize`: the FMA rounded once
    (``colorspace._fma_f32``), clamped, then ``colorspace.f32_to_u8``."""
    v = torch.clamp(colorspace._fma_f32(rgb, colorspace._INV255,
                                        dy.to(torch.float32)[..., None]),
                    0.0, 1.0)
    return colorspace.f32_to_u8(v) if quantize else v


def add_quantize(rgb: torch.Tensor, dy: torch.Tensor,
                 quantize: bool) -> torch.Tensor:
    """(..., 3) u8 + dY (...) f32 -> ``clip(u8 * f32(1/255) + dY, 0, 1)``
    with the sum rounded once: f32 (..., 3), or quantized to u8 when
    ``quantize``.

    CPU tensors take :func:`add_quantize_reference`; CUDA tensors launch
    the kernel or raise.
    """
    if rgb.device.type == "cpu":
        return add_quantize_reference(rgb, dy, quantize)
    if rgb.dtype != torch.uint8 or rgb.ndim < 1 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb must be (..., 3) uint8, got "
                         f"{tuple(rgb.shape)} {rgb.dtype}")
    if dy.dtype != torch.float32 or tuple(dy.shape) != tuple(rgb.shape[:-1]):
        raise ValueError(f"dy must be float32 {tuple(rgb.shape[:-1])}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if dy.device != rgb.device:
        raise ValueError("rgb and dy must be on one device")
    if not (rgb.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rgb and dy must be contiguous")
    if rgb.device.type != "cuda":
        raise ValueError(f"add_quantize runs on CPU or CUDA, not {rgb.device}")
    out = torch.empty(rgb.shape, device=rgb.device,
                      dtype=torch.uint8 if quantize else torch.float32)
    fn = _build.kernel("ssw_add_quantize", _ARGTYPES)
    with torch.cuda.device(rgb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(rgb.data_ptr(), dy.data_ptr(), out.data_ptr(), dy.numel(),
                  int(quantize), stream)
    _build.check(code, "ssw_add_quantize")
    global LAUNCHES
    LAUNCHES += 1
    return out
