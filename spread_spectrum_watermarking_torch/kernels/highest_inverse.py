"""K10: HIGHEST's sparse inverse, dY of the n changed coefficients, added
to the u8 image and quantized in the same kernel (or written as f32 dY).

The inverse of every HIGHEST sparse embed (``models/pipeline.py``). The
JAX package leaves it to XLA (``models/pipeline.py:41-92``,
``_sparse_idct_delta``; the add and clip at :433-435, the quantize at
:443), so it replaces no ``pallas_call``. Its plain version is the route
the port ran before K10: ``ops.dct.sparse_factors_f32``, the f32 product of
the factors (TF32 off), times ``f32(4/(W*H))``
(:func:`sparse_delta_reference`), then K7's rounding
(``add_quantize.add_quantize_reference``, :func:`highest_inverse_reference`):
the CPU path, and what the kernel is held against on the card.

The kernel (``csrc/highest_inverse.cu``, which says what bounds it on the
H100 and how its design answers that) contracts over each image's distinct
rows instead of its n indices: with S the shorter side and L the longer,
a_i and b_i an index's coordinates along them, A the image's distinct a_i
ascending, ``M[a, l] = sum_{i: a_i = a} delta_i D_L[l, b_i]`` (f32, i
ascending) and ``dY[s', l] = s sum_{a in A} D_S[s', a] M[a, l]`` in K9's
3xTF32 arithmetic (each k-step's tensor-core sum added in f32), then the
u8 epilogue with K7's rounding. :func:`k10_bound` is the per-pixel
tolerance between dY and its plain version, :func:`f64_error` the error
against an f64 product, :func:`gates` what the kernel must pass.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import trace
from ..ops import dct
from . import _build
from .add_quantize import add_quantize_reference
from .dct2d_fused import SPLIT_TERMS, inverse_scale, split_tf32
from .read_tail import count_rows

#: Launches of the CUDA kernel in this process (plain-version calls excluded).
LAUNCHES = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_P, _L, _P, _P, _P, _I, _P, _I, _F, _P, _L, _L, _L, _L, _P, _I,
             _P, _L, _P, _L, _P, _L, _I, _I, _I, _I, _P, _P]
_U = 2.0 ** -24  # f32's unit roundoff
_DEPTH = 32      # the kernel's slots a stage: M's rows are padded to it


def _check(delta: torch.Tensor, idx: torch.Tensor, h: int, w: int,
           rgb: torch.Tensor | None) -> None:
    if delta.dtype != torch.float32 or delta.ndim != 2:
        raise ValueError(f"delta must be (B, n) float32, got "
                         f"{tuple(delta.shape)} {delta.dtype}")
    b, n = delta.shape
    if idx.dtype != torch.int64 or idx.shape not in ((n,), (b, n)):
        raise ValueError(f"idx must be int64 ({n},) or ({b}, {n}), got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if h < 1 or w < 1:
        raise ValueError(f"the image must have a pixel, got {h} x {w}")
    if idx.device != delta.device:
        raise ValueError("idx must be on delta's device")
    if rgb is not None and (rgb.dtype != torch.uint8
                            or tuple(rgb.shape) != (b, h, w, 3)):
        raise ValueError(f"rgb must be ({b}, {h}, {w}, 3) uint8, got "
                         f"{tuple(rgb.shape)} {rgb.dtype}")
    if rgb is not None and rgb.device != delta.device:
        raise ValueError("rgb must be on delta's device")
    if delta.device.type == "cpu" and idx.numel() and (
            int(idx.min()) < 0 or int(idx.max()) >= h * w):
        raise ValueError(f"idx must lie in [0, {h * w})")


def sparse_delta_reference(delta: torch.Tensor, idx: torch.Tensor, h: int,
                           w: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`sparse_delta`: the f32 product of
    the factors of ``ops.dct.sparse_factors_f32`` (TF32 off), times
    ``f32(4/(W*H))``."""
    a, b = dct.sparse_factors_f32(delta, idx.expand(delta.shape), h, w)
    return dct.matmul_f32(a.transpose(-1, -2), b) * inverse_scale(h, w)


def highest_inverse_reference(rgb: torch.Tensor, delta: torch.Tensor,
                              idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`highest_inverse`:
    :func:`sparse_delta_reference`, then K7's rounding."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    return add_quantize_reference(
        rgb, sparse_delta_reference(delta, idx, h, w), True)


def sparse_delta(delta: torch.Tensor, idx: torch.Tensor, h: int, w: int
                 ) -> torch.Tensor:
    """(B, n) f32 updates ``delta`` at int64 flat indices ``idx`` (n,) or
    (B, n) in [0, H W) -> the luma delta dY (B, H, W) f32 of the inverse
    DCT: K10's dY mode.

    CPU tensors take :func:`sparse_delta_reference`; CUDA tensors launch
    the kernel or raise. An index out of range raises: at once on the CPU;
    on the card as a device-side assert at the next synchronisation (as
    ``highest_read`` does), after which the process's CUDA context is
    unusable.
    """
    _check(delta, idx, h, w, None)
    if delta.device.type == "cpu":
        count_rows("k10", idx, h, w, delta.shape[0])
        return sparse_delta_reference(delta, idx, h, w)
    return _launch(delta, idx, h, w, None)


def highest_inverse(rgb: torch.Tensor, delta: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """u8 (B, H, W, 3) ``rgb`` (any strides), (B, n) f32 ``delta``, int64
    ``idx`` (n,) or (B, n) -> the marked u8 (B, H, W, 3):
    ``clip(rgb * f32(1/255) + dY, 0, 1)`` rounded once and quantized, dY
    as :func:`sparse_delta` computes it. Neither dY nor the factors reach
    device memory.

    CPU tensors take :func:`highest_inverse_reference`; CUDA tensors launch
    the kernel or raise, as :func:`sparse_delta`.
    """
    h, w = (rgb.shape[1], rgb.shape[2]) if rgb.ndim == 4 else (1, 1)
    _check(delta, idx, h, w, rgb)
    if delta.device.type == "cpu":
        count_rows("k10", idx, h, w, delta.shape[0])
        return highest_inverse_reference(rgb, delta, idx)
    return _launch(delta, idx, h, w, rgb)


def _pitch(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=16)
def _short_parts(s: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The TF32 parts of D_S^T (row a is the inverse basis's column a),
    (S, pitch) with zeros past S: gathered at each image's listed rows
    into the product's B operand."""
    d = dct.basis_tensor(s, device, torch.float32, inverse=True).t()
    d = torch.nn.functional.pad(d, (0, _pitch(s) - s))
    return tuple(p.contiguous() for p in split_tf32(d))


@functools.lru_cache(maxsize=16)
def _long_basis(n: int, device: torch.device) -> torch.Tensor:
    """D_L^T, (L, pitch) with zeros past L: M's rows."""
    d = dct.basis_tensor(n, device, torch.float32, inverse=True).t()
    return torch.nn.functional.pad(d, (0, _pitch(n) - n)).contiguous()


def _launch(delta: torch.Tensor, idx: torch.Tensor, h: int, w: int,
            rgb: torch.Tensor | None) -> torch.Tensor:
    """The kernel's five launches on the current stream: the u8 image, or
    dY without ``rgb``."""
    dev = delta.device
    if dev.type != "cuda":
        raise ValueError(f"highest_inverse runs on CPU or CUDA, not {dev}")
    b, n = delta.shape
    s, l = min(h, w), max(h, w)
    delta = delta.contiguous()
    if idx.stride(-1) != 1:
        idx = idx.contiguous()
    # An index set shared by the batch (stride 0) is read once per image.
    idx_stride = idx.stride(0) if idx.ndim == 2 else 0
    cap = min(n, s)
    m_rows = max(_DEPTH, -(-cap // _DEPTH) * _DEPTH)
    b_hi, b_lo = _short_parts(s, dev)
    basis_l = _long_basis(l, dev)
    m = torch.empty(b * m_rows * _pitch(l), dtype=torch.float32, device=dev)
    g = torch.empty(2 * b * s * m_rows, dtype=torch.float32, device=dev)
    meta = torch.empty(b * (2 + 2 * cap + 3 * n), dtype=torch.int32,
                       device=dev)
    if rgb is None:
        out = torch.empty((b, h, w), dtype=torch.float32, device=dev)
        rgb_ptr, strides = None, (0, 0, 0, 0)
    else:
        out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=dev)
        rgb_ptr, strides = rgb.data_ptr(), rgb.stride()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.kernel("ssw_highest_inverse", _ARGTYPES)(
            idx.data_ptr(), idx_stride, delta.data_ptr(), b_hi.data_ptr(),
            b_lo.data_ptr(), _pitch(s), basis_l.data_ptr(), _pitch(l),
            inverse_scale(h, w), rgb_ptr, *strides, out.data_ptr(),
            int(rgb is not None), m.data_ptr(), m.numel(), g.data_ptr(),
            g.numel(), meta.data_ptr(), meta.numel(), b, h, w, n,
            trace.row_total("k10", b, dev), stream)
    _build.check(code, "ssw_highest_inverse")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _terms(delta: torch.Tensor, idx: torch.Tensor, h: int, w: int):
    """Per image, in f64 on ``delta``'s device: ``(exact, mag, rows)``, the
    f64 dY ``s sum_i D_S[s', a_i] delta_i D_L[l, b_i]`` of the f32
    operands (H, W), its magnitude ``s sum_i |D_S[s', a_i] delta_i D_L[l,
    b_i]|`` (H, W), and the image's count |A| of distinct a_i."""
    b, n = delta.shape
    idx = idx.expand(b, n)
    rows, cols = idx // w, idx % w
    dh = dct.basis_tensor(h, delta.device, torch.float32, inverse=True)
    dw = dct.basis_tensor(w, delta.device, torch.float32, inverse=True)
    dh, dw, s = dh.double(), dw.double(), inverse_scale(h, w)
    for i in range(b):
        a = dh[:, rows[i]] * delta[i].double()            # (H, n)
        c = dw[:, cols[i]]                                # (W, n)
        along_s = rows[i] if h <= w else cols[i]
        yield (s * (a @ c.t()), s * (a.abs() @ c.abs().t()),
               int(torch.unique(along_s).numel()))


def _bound_terms(rows: int, n: int) -> float:
    return SPLIT_TERMS / 2 + 2 * (rows + n) + 2


def k10_bound(delta: torch.Tensor, idx: torch.Tensor, h: int, w: int
              ) -> torch.Tensor:
    """(B, H, W) f64: how far the kernel's dY may lie from its plain
    version at each pixel,

        (SPLIT_TERMS / 2 + 2 (|A| + n) + 2) u s sum_a |D_S[s', a]| sum_{i: a_i = a} |delta_i D_L[l, b_i]|,

    u = 2^-24, s = f32(4/(W H)), |A| the image's distinct a_i. Each route
    against the f64 dY of the f32 operands: the kernel's M takes one
    rounded product and at most n - 1 f32 additions per term (n u); its
    product one pass's TF32 split (at most 12 (1 + 2^-10) u of |D_S| |M|
    a product, ``SPLIT_TERMS / 2``) and an f32 sum over the |A| slots in
    k-steps (|A| u); the plain route one rounded product D_S delta per
    term and the f32 sum of n terms in cuBLAS's order ((n + 1) u, with or
    without FMAs); each route one rounding of the scale product (u). The
    sum of the two routes' errors, (12.5 + 2 n + |A| + 3) u, lies within
    the bound since |A| >= 1; the sums' second-order terms are far inside
    the slack of 2 |A|."""
    out = [_bound_terms(rows, delta.shape[1]) * _U * mag
           for _, mag, rows in _terms(delta, idx, h, w)]
    return torch.stack(out) if out else torch.zeros(
        (0, h, w), dtype=torch.float64, device=delta.device)


def f64_error(dy: torch.Tensor, delta: torch.Tensor, idx: torch.Tensor
              ) -> float:
    """The largest error of ``dy`` (:func:`sparse_delta` of ``(delta,
    idx)``, or its plain version's) against the f64 dY of the f32
    operands, in units of ``2^-24 s sum_i |D_S delta_i D_L|``
    (:func:`k10_bound`'s unit)."""
    h, w = dy.shape[1:]
    worst = 0.0
    for i, (exact, mag, _) in enumerate(_terms(delta, idx, h, w)):
        err = (dy[i].double() - exact).abs()
        worst = max(worst, float((err / (_U * mag).clamp_min(1e-300)).max()))
    return worst


def gates(dy: torch.Tensor, delta: torch.Tensor, idx: torch.Tensor,
          rgb: torch.Tensor | None = None,
          out: torch.Tensor | None = None) -> dict:
    """The gates K10's dY (``dy``, its dY mode's result) and, given the
    image, its u8 output ``out`` must pass, and their readings: dY within
    :func:`k10_bound` of the plain version at every pixel
    (``within_bound``); an f64 error (:func:`f64_error`) at most the plain
    version's plus one pass's split term (``within_f64``), which catches a
    dropped lo term that the bound, growing with |A| + n, lets through;
    ``no_worse_than_plain``, the two f64 errors as they are, which the
    card's checks require at 48 x 1080p and 8 x 4K (at small sizes, where
    the f32 sums are short, the plain version may lie the closer by a
    unit); ``u8_bit_equal_own_dy``, ``out`` equal to K7's rounding of
    ``dy``; ``max_u8_step_from_plain``, the largest step between ``out``
    and the plain version's u8 (at most 1 to pass)."""
    h, w = dy.shape[1:]
    ref = sparse_delta_reference(delta, idx, h, w)
    bound = k10_bound(delta, idx, h, w)
    d = (dy.double() - ref.double()).abs()
    kernel, plain = (f64_error(x, delta, idx) for x in (dy, ref))
    g = {"share_bit_equal": float((d == 0).double().mean()),
         "max_abs_err": float(d.max()) if d.numel() else 0.0,
         "max_share_of_bound_used": float(
             (d / bound.clamp_min(1e-300)).max()) if d.numel() else 0.0,
         "kernel_f64_err": kernel, "plain_f64_err": plain,
         "within_bound": bool((d <= bound).all()),
         "within_f64": kernel <= plain + SPLIT_TERMS / 2,
         "no_worse_than_plain": kernel <= plain,
         "finite": bool(dy.isfinite().all())}
    if out is not None:
        own = add_quantize_reference(rgb, dy, True)
        plain_u8 = add_quantize_reference(rgb, ref, True)
        step = (out.int() - plain_u8.int()).abs()
        g.update(u8_bit_equal_own_dy=bool(torch.equal(out, own)),
                 max_u8_step_from_plain=int(step.max()) if step.numel()
                 else 0,
                 share_u8_differing=float((step != 0).double().mean())
                 if step.numel() else 0.0)
    return g
