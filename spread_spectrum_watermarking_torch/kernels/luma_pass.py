"""K1: u8 RGB -> luma -> one DCT-II pass over the shorter axis (bf16 out).

Replaces the TPU kernel ``luma_pass`` (``ops/fused_dct.py`` of the JAX
package, ``pallas_call`` at :295, removed in b5b6c44), with its DEFAULT and
its HIGH (``n_dots=3``) modes. The CUDA source, ``csrc/luma_pass.cu``, says
what bounds it on the H100 and how its design answers that.
:func:`luma_pass_reference` is its plain version: the CPU path, and what
the kernel is held against on the card.

Single mode (``base=None``) is ``pipeline._half_pass`` at DEFAULT: luma of
``u8 * f32(1/255)`` (``colorspace.luma_u8``), rounded to bf16, one pass.
High mode (``precision=Precision.HIGH``) is ``_half_pass`` at HIGH: the f32
luma, one bf16x3 pass (``ops.dct.matmul_bf16x3``), the sum rounded once to
bf16. Pair mode is the read tail's first pass, at DEFAULT: luma of the
exact integer difference ``rgb - base``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import Precision
from ..ops import colorspace, dct
from . import _build

#: Launches of the CUDA kernel in single or pair mode in this process
#: (plain-version calls excluded).
LAUNCHES = 0
#: Launches of the CUDA kernel in high mode in this process.
HIGH_LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _P]


def _check_mode(base: torch.Tensor | None, precision: Precision) -> None:
    if precision is Precision.HIGHEST:
        raise ValueError("luma_pass runs at DEFAULT or HIGH, not HIGHEST")
    if base is not None and precision is not Precision.DEFAULT:
        raise ValueError("pair mode (base given) runs at DEFAULT only")


def luma_pass_reference(rgb: torch.Tensor, base: torch.Tensor | None = None,
                        precision: Precision = Precision.DEFAULT
                        ) -> torch.Tensor:
    """Plain PyTorch version of :func:`luma_pass`."""
    _check_mode(base, precision)
    ax = dct.shorter_axis(rgb.shape[-3], rgb.shape[-2])
    if precision is Precision.HIGH:
        return dct.dct2_pass(colorspace.luma_u8(rgb), axis=ax,
                             precision=Precision.HIGH).to(torch.bfloat16)
    if base is None:
        y = colorspace.luma_u8(rgb)
    else:
        y = colorspace.luma_diff(base, rgb)
    return dct.dct2_pass(y.to(torch.bfloat16), axis=ax,
                         precision=Precision.DEFAULT, out_dtype=torch.bfloat16)


@functools.lru_cache(maxsize=16)
def _basis_hi_lo(n: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16x3 split of the f32 DCT-II basis of size n, as bf16 tensors
    on ``device``: the same parts ``dct.matmul_bf16x3`` forms."""
    hi, lo = dct.split_bf16(dct.basis_tensor(n, device, torch.float32))
    return hi.to(torch.bfloat16), lo.to(torch.bfloat16)


def _check_image(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"{name} must be (B, H, W, 3) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def luma_pass(rgb: torch.Tensor, base: torch.Tensor | None = None,
              precision: Precision = Precision.DEFAULT) -> torch.Tensor:
    """(B, H, W, 3) u8 -> (B, H, W) bf16: luma, then the DCT-II pass over
    the shorter axis at ``precision`` (DEFAULT or HIGH). With ``base``
    (DEFAULT only), the luma of ``rgb - base``.

    CPU tensors take :func:`luma_pass_reference`; CUDA tensors launch the
    kernel or raise.
    """
    _check_mode(base, precision)
    if rgb.device.type == "cpu":
        return luma_pass_reference(rgb, base, precision)
    _check_image(rgb, "rgb")
    if base is not None:
        _check_image(base, "base")
        if base.shape != rgb.shape or base.device != rgb.device:
            raise ValueError("base must match rgb in shape and device")
    if rgb.device.type != "cuda":
        raise ValueError(f"luma_pass runs on CPU or CUDA, not {rgb.device}")
    b, h, w = rgb.shape[:3]
    out = torch.empty((b, h, w), dtype=torch.bfloat16, device=rgb.device)
    global LAUNCHES, HIGH_LAUNCHES
    with torch.cuda.device(rgb.device):
        stream = torch.cuda.current_stream().cuda_stream
        if precision is Precision.HIGH:
            hi, lo = _basis_hi_lo(min(h, w), rgb.device)
            name = "ssw_luma_pass_high"
            code = _build.kernel(name, _ARGTYPES)(
                rgb.data_ptr(), hi.data_ptr(), lo.data_ptr(), out.data_ptr(),
                b, h, w, stream)
        else:
            basis = dct.basis_tensor(min(h, w), rgb.device, torch.bfloat16)
            name = "ssw_luma_pass"
            code = _build.kernel(name, _ARGTYPES)(
                rgb.data_ptr(), None if base is None else base.data_ptr(),
                basis.data_ptr(), out.data_ptr(), b, h, w, stream)
    _build.check(code, name)
    if precision is Precision.HIGH:
        HIGH_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
