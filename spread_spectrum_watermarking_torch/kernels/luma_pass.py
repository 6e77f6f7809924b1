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
from . import _build, _tiles

#: Launches of the CUDA kernel in single or pair mode in this process
#: (plain-version calls excluded).
LAUNCHES = 0
#: Of those, the launches in pair mode.
PAIR_LAUNCHES = 0
#: Launches of the CUDA kernel in high mode in this process.
HIGH_LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _L, _P, _I, _I, _I, _P]
_HIGH_ARGTYPES = [_P, _P, _P, _L, _P, _I, _I, _I, _P]


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


def f64_error(out: torch.Tensor, rgb: torch.Tensor,
              base: torch.Tensor | None = None,
              precision: Precision = Precision.DEFAULT) -> float:
    """The largest error of ``out`` (:func:`luma_pass` of the same
    arguments, or its plain version's) beyond its one bf16 rounding, in
    units of ``2^-24 sum_k |C y|``: ``(|out - exact| - half a bf16 ulp)``
    where positive, ``exact`` the f64 product of the operands the pass
    multiplies (bf16 luma and basis; at HIGH the hi/lo parts of its three
    products). 0 where every output is the correctly rounded sum."""
    _check_mode(base, precision)
    y = colorspace.luma_u8(rgb) if base is None else colorspace.luma_diff(
        base, rgb)
    h, w = rgb.shape[-3], rgb.shape[-2]
    c = dct.basis_tensor(min(h, w), rgb.device, torch.float32)
    a, b = (c, y) if h <= w else (y, c.t())
    if precision is Precision.HIGH:
        a, b = dct._bf16x3_operands(a, b, -1, -2)
    else:
        a, b = dct._bf16_values(a), dct._bf16_values(b)
    a, b = a.double(), b.double()
    exact = torch.matmul(a, b)
    unit = 2.0 ** -24 * torch.matmul(a.abs(), b.abs())
    got = out.double()
    big = torch.maximum(got.abs(), exact.abs()).clamp_min(2.0 ** -126)
    half_ulp = torch.exp2(torch.floor(torch.log2(big)) - 8)
    excess = ((got - exact).abs() - half_ulp).clamp_min(0)
    return float((excess / unit.clamp_min(1e-300)).max())


@functools.lru_cache(maxsize=16)
def _basis_tiles(n: int, device: torch.device, precision: Precision
                 ) -> torch.Tensor:
    """The tile image (``_tiles.tile_image``) of the DCT-II basis of size
    n on ``device``: of its bf16 values at DEFAULT; at HIGH of the hi and
    lo parts of its bf16x3 split (the parts ``dct.matmul_bf16x3`` forms),
    one after the other."""
    c = dct.basis_tensor(n, device, torch.float32)
    if precision is Precision.HIGH:
        c = torch.stack(dct.split_bf16(c))
    return _tiles.tile_image(c)


def _work_elems(b: int, h: int, w: int, precision: Precision) -> int:
    """bf16 elements of the luma's tile image: rows along the longer axis,
    k along the shorter, its two parts at HIGH."""
    rt, kt = _tiles.tile_counts(max(h, w), min(h, w))
    parts = 2 if precision is Precision.HIGH else 1
    return b * parts * rt * kt * _tiles.ROWS * _tiles.DEPTH


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
    n_work = _work_elems(b, h, w, precision)
    work = torch.empty(n_work, dtype=torch.bfloat16, device=rgb.device)
    basis = _basis_tiles(min(h, w), rgb.device, precision)
    global LAUNCHES, PAIR_LAUNCHES, HIGH_LAUNCHES
    with torch.cuda.device(rgb.device):
        stream = torch.cuda.current_stream().cuda_stream
        if precision is Precision.HIGH:
            name = "ssw_luma_pass_high"
            code = _build.kernel(name, _HIGH_ARGTYPES)(
                rgb.data_ptr(), basis.data_ptr(), work.data_ptr(), n_work,
                out.data_ptr(), b, h, w, stream)
        else:
            name = "ssw_luma_pass"
            code = _build.kernel(name, _ARGTYPES)(
                rgb.data_ptr(), None if base is None else base.data_ptr(),
                basis.data_ptr(), work.data_ptr(), n_work, out.data_ptr(),
                b, h, w, stream)
    _build.check(code, name)
    if precision is Precision.HIGH:
        HIGH_LAUNCHES += 1
    else:
        LAUNCHES += 1
        PAIR_LAUNCHES += int(base is not None)
    return out
