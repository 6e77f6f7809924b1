"""K9: the HIGHEST read, the 2-D DCT-II of an f32 luma plane at n indices.

The read of every HIGHEST ``embed_verified`` and ``extract``
(``models/pipeline.py``): the derived image's coefficients at the base's
n ranked indices. The JAX package leaves it to XLA (``ops/dct.py:256-302``,
``dct2_coeffs_at``, at ``models/pipeline.py:513, 700``), so it replaces no
``pallas_call``. :func:`highest_read_reference` is its plain version, the
route the port ran before K9 (``ops.dct.dct2_coeffs_at``: an f32 pass over
the whole shorter axis, TF32 off, then the gather-dot): the CPU path, and
what the kernel is held against on the card.

The kernel (``csrc/highest_read.cu``, which says what bounds it on the
H100 and how its design answers that) computes the first pass only at the
distinct rows of the indices, in K6a's 3xTF32 arithmetic
(``csrc/tf32x3.cuh``): in landscape (H <= W) ``num[i] = sum_w D[r_i, w]
C_w[c_i, w]`` with ``D[a, :] = sum_h C_h[a, h] y[h, :]`` for the listed
rows a, ``r_i = idx_i // W``, ``c_i = idx_i % W``; portrait is the mirror.
Three launches: the compaction of each image's rows (K5's,
``read_tail.compact_rows_reference`` is its plain version), the pass at
those rows (tiles of 64 slots by 192 positions, walked by one persistent
block per SM over the live tiles only, a producer warpgroup feeding a
ring on mbarriers, each k-step's f32 add overlapped with the next step's
products), the dots. Its sums run in another order than the plain
version's and its first pass splits each operand into TF32 parts:
:func:`k9_bound` is the per-index tolerance between the two,
:func:`f64_error` the error against an f64 product, :func:`gates` both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import trace
from ..ops import dct
from . import _build
from .dct2d_fused import SPLIT_TERMS, split_tf32
from .read_tail import count_rows

#: Launches of the CUDA kernel in this process (plain-version calls excluded).
LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _L, _P, _P, _I, _P, _I, _P, _L, _P, _L, _P, _I, _I, _I,
             _I, _P, _P]
_U = 2.0 ** -24  # f32's unit roundoff


def _check(y: torch.Tensor, idx: torch.Tensor) -> None:
    if y.dtype != torch.float32 or y.ndim != 3:
        raise ValueError(f"y must be (B, H, W) float32, got "
                         f"{tuple(y.shape)} {y.dtype}")
    b = y.shape[0]
    if idx.dtype != torch.int64 or idx.ndim not in (1, 2) or (
            idx.ndim == 2 and idx.shape[0] != b):
        raise ValueError(f"idx must be int64 (n,) or ({b}, n), got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != y.device:
        raise ValueError("idx must be on y's device")


def highest_read_reference(y: torch.Tensor, idx: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`highest_read`:
    ``ops.dct.dct2_coeffs_at`` at HIGHEST."""
    return dct.dct2_coeffs_at(y, idx.expand(y.shape[0], idx.shape[-1]))


def highest_read(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 ``y`` (a luma plane), int64 flat indices ``idx`` (n,)
    or (B, n) in [0, H W) -> (B, n) f32: the 2-D DCT-II of ``y`` at the
    indices.

    CPU tensors take :func:`highest_read_reference`; CUDA tensors launch
    the kernel or raise. An index out of range raises: at once on the CPU;
    on the card as a device-side assert at the next synchronisation (as
    ``read_tail`` does), after which the process's CUDA context is
    unusable.
    """
    _check(y, idx)
    h, w = y.shape[1:]
    if y.device.type == "cpu":
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= h * w):
            raise ValueError(f"idx must lie in [0, {h * w})")
        count_rows("k9", idx, h, w, y.shape[0])
        return highest_read_reference(y, idx)
    out = _launch(y, idx)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _pitch(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=16)
def _short_parts(s: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The TF32 parts of the f32 DCT-II basis of S, (S, pitch) with zeros
    past S: the first pass's B operand."""
    c = dct.basis_tensor(s, device, torch.float32)
    c = torch.nn.functional.pad(c, (0, _pitch(s) - s))
    return tuple(p.contiguous() for p in split_tf32(c))


@functools.lru_cache(maxsize=16)
def _long_basis(n: int, device: torch.device) -> torch.Tensor:
    """The f32 DCT-II basis of L, (L, pitch) with zeros past L: the dots'
    C_L."""
    c = dct.basis_tensor(n, device, torch.float32)
    return torch.nn.functional.pad(c, (0, _pitch(n) - n)).contiguous()


def _launch(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's three launches on the current stream: (B, n) f32."""
    if y.device.type != "cuda":
        raise ValueError(f"highest_read runs on CPU or CUDA, not {y.device}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    b, h, w = y.shape
    s, l = min(h, w), max(h, w)
    n = idx.shape[-1]
    if idx.stride(-1) != 1:
        idx = idx.contiguous()
    # An index set shared by the batch (stride 0) is read once per image.
    idx_stride = idx.stride(0) if idx.ndim == 2 else 0
    cap = min(n, s)
    dev = y.device
    s_hi, s_lo = _short_parts(s, dev)
    basis_l = _long_basis(l, dev)
    d = torch.empty(b * cap * _pitch(l), dtype=torch.float32, device=dev)
    meta = torch.empty(b * (1 + cap + n), dtype=torch.int32, device=dev)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.kernel("ssw_highest_read", _ARGTYPES)(
            y.data_ptr(), idx.data_ptr(), idx_stride, s_hi.data_ptr(),
            s_lo.data_ptr(), _pitch(s), basis_l.data_ptr(), _pitch(l),
            d.data_ptr(), d.numel(), meta.data_ptr(), meta.numel(),
            out.data_ptr(), b, h, w, n, trace.row_total("k9", b, dev), stream)
    _build.check(code, "ssw_highest_read")
    return out


def _terms(y: torch.Tensor, idx: torch.Tensor):
    """Per image, in f64 on ``y``'s device, for landscape and portrait
    alike (S the shorter axis, L the longer, a_i and b_i the index's
    coordinates along them): ``(d, scale, cb)``, the exact first-pass
    rows ``D[i, l] = sum_s C_S[a_i, s] y(s, l)`` (n, L), the dot's scale
    ``sum_l |C_L[b_i, l]| sum_s |C_S[a_i, s] y(s, l)|`` (n,) and the
    basis rows ``C_L[b_i]`` (n, L); the f32 bases and luma as f64."""
    h, w = y.shape[1:]
    land = h <= w
    idx = idx.expand(y.shape[0], idx.shape[-1])
    rows, cols = idx // w, idx % w
    a_all, b_all = (rows, cols) if land else (cols, rows)
    cs = dct.basis_tensor(min(h, w), y.device, torch.float32).double()
    cl = dct.basis_tensor(max(h, w), y.device, torch.float32).double()
    for i in range(y.shape[0]):
        yi = y[i].double()
        if not land:
            yi = yi.t()                                   # (S, L)
        ca, cb = cs[a_all[i]], cl[b_all[i]]
        yield ca @ yi, (cb.abs() * (ca.abs() @ yi.abs())).sum(-1), cb


def k9_bound(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, n) f64: how far the kernel may lie from its plain version at
    each index (landscape; the mirror in portrait):

        (SPLIT_TERMS / 2 + 2 (S + L)) u sum_l |C_L[b_i, l]| sum_s |C_S[a_i, s] y[s, l]|,

    u = 2^-24: one pass's share of K6's TF32 split (at most 12 (1 +
    2^-10) u of |a| |b| a product, ``kernels.dct2d_fused.SPLIT_TERMS``
    for two passes), the first pass's f32 sum of S terms taken in another
    order than the plain version's (2 S, both orders' errors), and the
    dot's f32 sum of L terms so (2 L; the first pass's error carried
    through the dot is the first two terms, since |C_L| times the bound
    on |D| is the scale)."""
    s, l = min(y.shape[1:]), max(y.shape[1:])
    terms = SPLIT_TERMS / 2 + 2 * (s + l)
    out = [terms * _U * scale for _, scale, _ in _terms(y, idx)]
    return torch.stack(out) if out else torch.zeros(
        (0, idx.shape[-1]), dtype=torch.float64, device=y.device)


def f64_error(out: torch.Tensor, y: torch.Tensor, idx: torch.Tensor
              ) -> float:
    """The largest error of ``out`` (:func:`highest_read` of the same
    arguments, or its plain version's) against the f64 read ``sum_l D[i,
    l] C_L[b_i, l]`` of the f32 operands, in units of ``2^-24 sum_l |C_L|
    sum_s |C_S y|`` (:func:`k9_bound`'s unit)."""
    worst = 0.0
    for i, (d, scale, cb) in enumerate(_terms(y, idx)):
        err = (out[i].double() - (d * cb).sum(-1)).abs()
        worst = max(worst, float((err / (_U * scale).clamp_min(1e-300))
                                 .max()))
    return worst


def gates(out: torch.Tensor, y: torch.Tensor, idx: torch.Tensor) -> dict:
    """The gates K9's result ``out`` must pass, and their readings: within
    :func:`k9_bound` of the plain version at every index
    (``within_bound``), and an f64 error (:func:`f64_error`) at most the
    plain version's plus one pass's split term, ``SPLIT_TERMS / 2`` units
    (``within_f64``). The second catches what the first, which grows with
    S + L, lets through: the split's lo terms dropped (a 1xTF32 pass, about
    100 units), a first pass rounded to a narrower type (hundreds).
    ``no_worse_than_plain`` compares the two f64 errors as they are: over a
    batch of ranked reads at 1080p and 4K the 3xTF32 first pass lies
    closer to the f64 read than cuBLAS's f32 pass, and the card's checks
    require it there; at small sizes, where the f32 sums are short, the
    plain version may read the closer by a unit or two."""
    ref = highest_read_reference(y, idx)
    bound = k9_bound(y, idx)
    d = (out.double() - ref.double()).abs()
    kernel, plain = (f64_error(x, y, idx) for x in (out, ref))
    return {"share_bit_equal": float((d == 0).double().mean()),
            "max_abs_err": float(d.max()) if d.numel() else 0.0,
            "max_share_of_bound_used": float(
                (d / bound.clamp_min(1e-300)).max()) if d.numel() else 0.0,
            "kernel_f64_err": kernel, "plain_f64_err": plain,
            "within_bound": bool((d <= bound).all()),
            "within_f64": kernel <= plain + SPLIT_TERMS / 2,
            "no_worse_than_plain": kernel <= plain,
            "finite": bool(out.isfinite().all())}
