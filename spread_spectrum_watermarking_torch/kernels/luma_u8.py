"""K8: the f32 luma of u8 RGB, bit for bit ``rgb_to_luma(u8_to_f32(x))``.

The HIGHEST tier's luma (``ops.colorspace.luma`` of a u8 image: the base's
in ``models/pipeline._forward``, the derived image's in every HIGHEST
read). It replaces no ``pallas_call``: the JAX package leaves
``rgb_to_luma(u8_to_f32(x))`` (``ops/colorspace.py:64-75`` and ``:121``)
to XLA. The CUDA source, ``csrc/luma_u8.cu``, says what bounds it on the
H100 and how its design answers that. :func:`luma_u8_reference` is its
plain version, a lookup in the table of every colour's luma
(``colorspace._luma_table``, 64 MB), bit-equal to the JAX package: the
CPU path, and what the kernel is held against, bit for bit, on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import colorspace
from . import _build

#: Launches of the CUDA kernel in this process (plain-version calls excluded).
LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _L, _L, _L, _L, _I, _I, _I, _P, _P]


def _check(rgb: torch.Tensor) -> None:
    if rgb.dtype != torch.uint8:
        raise TypeError("luma_u8 takes uint8 images")
    if rgb.ndim < 1 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb must be (..., 3) uint8, got {tuple(rgb.shape)}")


def luma_u8_reference(rgb: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`luma_u8`: the lookup at ``(r << 16) | (g <<
    8) | b`` in the table of :func:`colorspace.rgb_to_luma` of
    :func:`colorspace.u8_to_f32` of every colour."""
    _check(rgb)
    c = rgb.to(torch.int32)
    idx = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
    return colorspace._luma_table(rgb.device)[idx]


def luma_u8(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 -> (...) f32 luma, bit for bit
    ``colorspace.rgb_to_luma(colorspace.u8_to_f32(rgb))``; any view.

    CPU tensors take :func:`luma_u8_reference`; CUDA tensors launch the
    kernel or raise.
    """
    _check(rgb)
    if rgb.device.type == "cpu":
        return luma_u8_reference(rgb)
    if rgb.device.type != "cuda":
        raise ValueError(f"luma_u8 runs on CPU or CUDA, not {rgb.device}")
    x = rgb
    while x.ndim < 4:
        x = x.unsqueeze(0)
    if x.ndim > 4:
        x = x.flatten(0, x.ndim - 4)
    b, h, w = x.shape[:3]
    if max(h, w) >= 2 ** 31 or b * h * w >= 2 ** 62:
        raise ValueError(f"luma_u8: {tuple(rgb.shape)} is too large")
    # A contiguous image is one byte run whatever the strides of its
    # dimensions of size 1: give the kernel the canonical ones.
    strides = ((3 * h * w, 3 * w, 3, 1) if x.is_contiguous()
               else x.stride())
    out = torch.empty((b, h, w), dtype=torch.float32, device=rgb.device)
    fn = _build.kernel("ssw_luma_u8", _ARGTYPES)
    with torch.cuda.device(rgb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), *strides, b, h, w, out.data_ptr(), stream)
    _build.check(code, "ssw_luma_u8")
    global LAUNCHES
    LAUNCHES += 1
    return out.view(rgb.shape[:-1])
