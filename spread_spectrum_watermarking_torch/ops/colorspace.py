"""RGB <-> YIQ conversion and u8 <-> f32 quantization, in PyTorch.

Port of the JAX package's ``ops/colorspace.py``. These are also the plain
versions the kernels in ``..kernels`` are held against, so every rounding
point follows the JAX code as XLA compiles it on the CPU (``jax.jit``,
which every JAX pipeline runs under), not as its source reads: a division
by a constant is a product by the constant's f32 reciprocal (``u8 / 255``
is ``u8 * f32(1/255)``), the three-term channel sums are FMA chains (not
the left-to-right sums the JAX docstrings state), and u8 output rounds
half up (``floor(x + 0.5)``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import add_quantize
from ..kernels import luma_u8 as k8

# colorsys matrices (reference: src/yiq.rs:155-165), as the f32 values the
# JAX package multiplies by.
_RGB_TO_YIQ = np.array([[0.30, 0.59, 0.11],
                        [0.60, -0.28, -0.32],
                        [0.21, -0.52, 0.31]], np.float32)
_YIQ_TO_RGB = np.array([[1.0, 0.948262, 0.624013],
                        [1.0, -0.276066, -0.639810],
                        [1.0, -1.105450, 1.729860]], np.float32)
_LUMA = tuple(float(v) for v in _RGB_TO_YIQ[0])
# The reciprocals XLA multiplies by in place of ``/ 255`` and ``/ 25500``.
_INV255 = float(np.float32(1.0 / 255.0))
_INV25500 = float(np.float32(1.0 / 25500.0))


def _fma_f32(a: torch.Tensor, m: float, acc: torch.Tensor) -> torch.Tensor:
    """f32 ``fma(a, m, acc)``, correctly rounded (PyTorch has no fused
    multiply-add).

    The product of two f32 values is exact in f64; their f64 sum ``s`` may
    not be, and rounding ``s`` again to f32 could then round twice. So ``s``
    is first moved to round-to-odd (the f64 neighbour of the exact sum with
    an odd last bit, found from the exact error of the sum), from which one
    rounding to f32 is the correctly rounded result: f64 has more than
    24 + 2 bits.
    """
    p = a.to(torch.float64) * m
    c = acc.to(torch.float64)
    s = p + c
    bp = s - c                       # two-sum: s + err == p + c exactly
    err = (p - bp) + (c - (s - bp))
    bits = s.view(torch.int64)
    even = (bits & 1) == 0
    # Step the last bit towards the exact sum: +1 away from zero.
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & even, bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


def rgb_to_luma(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 RGB in [0, 1] -> (...) f32 luma.

    ``fma(b, .11, fma(g, .59, r * .30))``: the order in which the JAX
    package's three-term einsum sums on the CPU, so the two agree bit for
    bit (the test checks every u8 colour).
    """
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return _fma_f32(b, _LUMA[2], _fma_f32(g, _LUMA[1], r * _LUMA[0]))


@functools.lru_cache(maxsize=8)
def _luma_table(device: torch.device) -> torch.Tensor:
    """(2^24,) f32: :func:`rgb_to_luma` of :func:`u8_to_f32` of each colour,
    at index ``(r << 16) | (g << 8) | b``; 64 MB, built once per device
    (kernel K8's plain version, ``..kernels.luma_u8.luma_u8_reference``)."""
    v = torch.arange(1 << 24, dtype=torch.int32, device=device)
    rgb = torch.stack([v >> 16, (v >> 8) & 255, v & 255], dim=-1)
    return rgb_to_luma(u8_to_f32(rgb.to(torch.uint8)))


def luma_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 -> (...) f32, bit for bit ``rgb_to_luma(u8_to_f32(x))``:
    kernel K8 on a CUDA tensor (``..kernels.luma_u8``), which never builds
    the table; on the CPU a lookup in the table of every colour's luma
    (its plain version), which costs a fraction of the f64 emulation of
    the FMA chain."""
    return k8.luma_u8(rgb_u8)


def rgb_to_yiq(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 RGB in [0, 1] -> (..., 3) YIQ, no clamping.

    Each row is ``fma(m2, b, fma(m0, r, m1 * g))``: the order XLA gives the
    JAX package's ``(m0*r + m1*g) + m2*b`` on the CPU (the G product is
    rounded first; bit-equal to it over every u8 colour). Note that its Y
    differs in rounding from :func:`rgb_to_luma`'s, as in the JAX package.
    """
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    rows = [_fma_f32(b, float(m[2]), _fma_f32(r, float(m[0]), g * float(m[1])))
            for m in _RGB_TO_YIQ]
    return torch.stack(rows, dim=-1)


def yiq_to_rgb(yiq: torch.Tensor) -> torch.Tensor:
    """(..., 3) YIQ -> (..., 3) RGB, each channel clamped to [0, 1].

    Each row is ``fma(m2, q, fma(m1, i, m0 * y))``, the order XLA gives the
    JAX package's left-to-right sum on the CPU (reference
    src/yiq.rs:139-147,172-175).
    """
    y, i, q = yiq[..., 0], yiq[..., 1], yiq[..., 2]
    rows = [_fma_f32(q, float(m[2]), _fma_f32(i, float(m[1]), y * float(m[0])))
            for m in _YIQ_TO_RGB]
    return torch.clamp(torch.stack(rows, dim=-1), 0.0, 1.0)


def to_f32(rgb: torch.Tensor) -> torch.Tensor:
    """Integer RGB through :func:`u8_to_f32` (every integer dtype, as the
    JAX package's ``pipeline._to_f32`` scales them), float RGB as f32."""
    if rgb.is_floating_point():
        return rgb.to(torch.float32)
    return u8_to_f32(rgb)


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """The f32 luma plane of integer or float RGB: :func:`rgb_to_luma` of
    the f32 image (integers through :func:`u8_to_f32`; u8 by
    :func:`luma_u8`, kernel K8 on the card, which gives the same bits)."""
    if rgb.dtype == torch.uint8:
        return luma_u8(rgb)
    return rgb_to_luma(to_f32(rgb))


def luma_diff(base: torch.Tensor, derived: torch.Tensor) -> torch.Tensor:
    """Luma of (derived - base): (..., 3) pairs -> (...) f32.

    For u8 pairs the numerator ``30 dR + 59 dG + 11 dB`` is an exact
    integer, so the only rounding is the JAX code's ``/ 25500``, which XLA
    compiles to the product by ``f32(1/25500)`` -- bit-identical to the JAX
    version. Otherwise, as in the JAX package, the difference of the two
    f32 lumas (u8 images through :func:`u8_to_f32`, other dtypes cast to
    f32 unscaled).
    """
    if base.dtype != torch.uint8 or derived.dtype != torch.uint8:
        # As the JAX package computes it: other integer dtypes are taken as
        # floats here, unscaled (similarity does not depend on scale).
        def one(x):
            return luma_u8(x) if x.dtype == torch.uint8 else rgb_to_luma(
                x.to(torch.float32))
        return one(derived) - one(base)
    d = derived.to(torch.int32) - base.to(torch.int32)
    num = (30 * d[..., 0] + 59 * d[..., 1]) + 11 * d[..., 2]
    return num.to(torch.float32) * _INV25500


def u8_to_f32(rgb_u8: torch.Tensor) -> torch.Tensor:
    """u8 [0,255] -> f32 [0,1]; the ``image`` crate's ``into_rgb32f``, as
    the JAX pipelines compute it: ``u8 * f32(1/255)``, which differs from
    the true quotient by one ulp for 126 of the 256 values."""
    return rgb_u8.to(torch.float32) * _INV255


def f32_to_u8(rgb_f32: torch.Tensor) -> torch.Tensor:
    """f32 -> u8 via ``floor(clamp(x, 0, 1) * 255 + 0.5)`` (round half up)."""
    x = torch.clamp(rgb_f32, 0.0, 1.0) * 255.0
    return torch.floor(x + 0.5).to(torch.uint8)


def add_luma_delta_f32(rgb: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """RGB (..., 3), u8 or float, + luma delta (...) -> f32 RGB in [0, 1].

    ``clip(u8_to_f32(rgb) + dy, 0, 1)``, as the jitted JAX epilogues compute
    it: for u8 images XLA contracts ``u8 * f32(1/255) + dy`` into one FMA,
    so the sum is rounded once: kernel K7 in its f32 mode on a CUDA tensor
    (``..kernels.add_quantize``), its plain version (:func:`_fma_f32`) on
    the CPU; other integer dtypes by that plain version on every device.
    Float images add in f32. Y is the only modified plane and the
    Y column of YIQ->RGB is [1, 1, 1] (reference src/yiq.rs:161-165).
    """
    if rgb.dtype == torch.uint8:
        return add_quantize.add_quantize(
            rgb.contiguous(), dy.to(torch.float32).contiguous(),
            quantize=False)
    if not rgb.is_floating_point():  # the same single rounding, plain ops
        return torch.clamp(_fma_f32(rgb.to(torch.float32), _INV255,
                                    dy.to(torch.float32)[..., None]),
                           0.0, 1.0)
    return torch.clamp(rgb.to(torch.float32) + dy.to(torch.float32)[..., None],
                       0.0, 1.0)


def add_luma_delta_u8(rgb_u8: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """u8 RGB (..., 3) + luma delta (...) -> u8 RGB.

    ``clamp(floor((x + 255*dy) + 0.5), 0, 255)`` per channel, as the JAX
    version computes it: Y is the only modified plane and the Y column of
    YIQ->RGB is [1, 1, 1] (reference src/yiq.rs:161-165).
    """
    df = (dy.to(torch.float32) * 255.0)[..., None]
    x = rgb_u8.to(torch.float32)
    return torch.clamp(torch.floor((x + df) + 0.5), 0.0, 255.0).to(torch.uint8)


def np_f32_to_u8(rgb_f32: np.ndarray) -> np.ndarray:
    """Host-side (numpy) version of :func:`f32_to_u8` for IO paths: the JAX
    package's ``np_f32_to_u8``, numpy's arithmetic, not XLA's."""
    x = np.clip(rgb_f32, 0.0, 1.0) * 255.0
    return np.floor(x + 0.5).astype(np.uint8)


def np_u8_to_f32(rgb_u8: np.ndarray) -> np.ndarray:
    """Host-side (numpy) version of :func:`u8_to_f32` for IO paths: the JAX
    package's ``np_u8_to_f32`` (a true division by 255, as numpy does it)."""
    return rgb_u8.astype(np.float32) / 255.0
