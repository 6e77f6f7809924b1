"""K1: u8 RGB -> luma -> one DCT-II pass over the shorter axis (bf16 out).

Replaces the TPU kernel ``luma_pass`` (``ops/fused_dct.py`` of the JAX
package, ``pallas_call`` at :295, removed in b5b6c44). The CUDA source,
``csrc/luma_pass.cu``, says what bounds it on the H100 and how its design
answers that. :func:`luma_pass_reference` is its plain version: the CPU
path, and what the kernel is held against on the card.

Single mode (``base=None``) is ``pipeline._half_pass`` at DEFAULT: luma of
``u8 * f32(1/255)`` (``colorspace.luma_u8``), rounded to bf16, one pass.
Pair mode is the read tail's first pass: luma of the exact integer
difference ``rgb - base``.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import Precision
from ..ops import colorspace, dct
from . import _build

#: Launches of the CUDA kernel in this process (plain-version calls excluded).
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _P]


def luma_pass_reference(rgb: torch.Tensor,
                        base: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`luma_pass`."""
    if base is None:
        y = colorspace.luma_u8(rgb)
    else:
        y = colorspace.luma_diff(base, rgb)
    h, w = rgb.shape[-3], rgb.shape[-2]
    return dct.dct2_pass(y.to(torch.bfloat16), axis=dct.shorter_axis(h, w),
                         precision=Precision.DEFAULT, out_dtype=torch.bfloat16)


def _check_image(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"{name} must be (B, H, W, 3) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def luma_pass(rgb: torch.Tensor,
              base: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W, 3) u8 -> (B, H, W) bf16: luma, then the DCT-II pass over
    the shorter axis. With ``base``, the luma of ``rgb - base``.

    CPU tensors take :func:`luma_pass_reference`; CUDA tensors launch the
    kernel or raise.
    """
    if rgb.device.type == "cpu":
        return luma_pass_reference(rgb, base)
    _check_image(rgb, "rgb")
    if base is not None:
        _check_image(base, "base")
        if base.shape != rgb.shape or base.device != rgb.device:
            raise ValueError("base must match rgb in shape and device")
    if rgb.device.type != "cuda":
        raise ValueError(f"luma_pass runs on CPU or CUDA, not {rgb.device}")
    b, h, w = rgb.shape[:3]
    basis = dct.basis_tensor(min(h, w), rgb.device, torch.bfloat16)
    out = torch.empty((b, h, w), dtype=torch.bfloat16, device=rgb.device)
    fn = _build.kernel("ssw_luma_pass", _ARGTYPES)
    with torch.cuda.device(rgb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(rgb.data_ptr(), None if base is None else base.data_ptr(),
                  basis.data_ptr(), out.data_ptr(), b, h, w, stream)
    _build.check(code, "ssw_luma_pass")
    global LAUNCHES
    LAUNCHES += 1
    return out
