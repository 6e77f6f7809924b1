"""K5: the fast tiers' read tail, the 2-D DCT of the difference of two u8
images at n ranked indices.

The JAX package leaves this stage to XLA (``models/pipeline.py:278-288``:
``luma_diff``, one bf16 pass, ``dct2_dot_at``), so it replaces no
``pallas_call``. :func:`read_tail_reference` is its plain version, the
route the port ran before K5: K1's pair mode (``luma_pass_reference``),
then ``ops.dct.dct2_dot_at`` at DEFAULT. It is the CPU path and what the
kernel is held against on the card.

The kernel (``csrc/read_tail.cu``, which says what bounds it on the H100
and how its design answers that) computes one row of the first pass per
distinct row of the indices, never the (B, H, W) plane: in landscape
(H <= W) ``num[i] = sum_w bf16(sum_h C_h[r_i, h] y[h, w]) C_w[c_i, w]``
with ``r_i = idx_i // W``, ``c_i = idx_i % W``, y the pair luma and the
bases in bf16; portrait is the mirror. Four launches: the compaction of
each image's rows (:func:`compact_rows_reference` is its plain version),
the operands, the product at those rows, the dots. Its sums run in
another order than the plain version's: :func:`k5_bound` is the per-index
tolerance between the two, :func:`f64_error` the error against an f64
product.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import trace
from ..config import Precision
from ..ops import colorspace, dct
from . import _build, _tiles
from .luma_pass import _basis_tiles, _check_image, luma_pass_reference

#: Launches of the CUDA kernel in this process (plain-version calls excluded).
LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _L, _P, _P, _P, _L, _P, _L, _P, _L, _P,
             _I, _I, _I, _I, _P, _P]
_U = 2.0 ** -24  # f32's unit roundoff


def _check(derived: torch.Tensor, base: torch.Tensor,
           idx: torch.Tensor) -> None:
    for name, x in (("derived", derived), ("base", base)):
        if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"{name} must be (B, H, W, 3) uint8, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if base.shape != derived.shape or base.device != derived.device:
        raise ValueError("base must match derived in shape and device")
    b = derived.shape[0]
    if idx.dtype != torch.int64 or idx.ndim not in (1, 2) or (
            idx.ndim == 2 and idx.shape[0] != b):
        raise ValueError(f"idx must be int64 (n,) or ({b}, n), got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != derived.device:
        raise ValueError("idx must be on the images' device")


def count_rows(kernel: str, idx: torch.Tensor, h: int, w: int,
               b: int) -> None:
    """A plain version's ``trace`` row counter for ``kernel``: the counts
    its compaction would write, while a profiler session records."""
    if trace.on():
        trace.rows(kernel, compact_rows_reference(idx, h, w, b)[0], b)


def compact_rows_reference(idx: torch.Tensor, h: int, w: int, b: int
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain version of the kernel's compaction, for ``b`` images of H x W
    and flat indices ``idx`` (n,) or (b, n): each image's distinct
    coordinates along the shorter axis (a_i = idx // W in landscape,
    idx % W in portrait), as ``(count (b,), rows (b, min(n, S)) ascending
    and -1 past the count, slot (b, n))`` with ``rows[j, slot[j, i]] =
    a_i``. Like the kernel, it marks the rows in a map over S and places
    each by the count of marks before it."""
    s = min(h, w)
    idx = idx.expand(b, idx.shape[-1])
    a = idx // w if h <= w else idx % w
    mark = torch.zeros((b, s), dtype=torch.bool, device=idx.device)
    mark.scatter_(1, a, True)
    place = mark.long().cumsum(1) - 1
    rows = torch.full((b, min(idx.shape[-1], s)), -1, dtype=torch.long,
                      device=idx.device)
    image, row = mark.nonzero(as_tuple=True)
    rows[image, place[image, row]] = row
    return mark.sum(1), rows, place.gather(1, a)


def read_tail_reference(derived: torch.Tensor, base: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`read_tail`: K1's pair mode, then the
    gather-dot at the n indices, both at DEFAULT."""
    h, w = derived.shape[-3], derived.shape[-2]
    td = luma_pass_reference(derived, base)
    return dct.dct2_dot_at(td, idx, contracted_axis=dct.shorter_axis(h, w),
                           precision=Precision.DEFAULT)


@functools.lru_cache(maxsize=16)
def _long_basis(n: int, device: torch.device) -> torch.Tensor:
    """The bf16 DCT-II basis of size n, (n, pitch) row-major with a pitch of
    whole 128-column tiles and zeros past n: the epilogue's C_L."""
    pitch = _tiles.tile_counts(n, 1)[0] * _tiles.ROWS
    c = dct.basis_tensor(n, device, torch.bfloat16)
    return torch.nn.functional.pad(c, (0, pitch - n)).contiguous()


def _layout(b: int, h: int, w: int, n: int) -> tuple[int, int, int]:
    """The kernel's scratch, in elements (``Layout`` in the source): bf16
    ``work``, the luma's tile image (rows along the longer axis) and the
    listed basis rows' (ceil(min(n, S) / 128) tiles of 128 rows), both as
    deep as the shorter axis S; bf16 ``drows``, bf16(D), as many rows of
    the longer axis padded to whole tiles; int32 ``meta``, each image's
    count of distinct rows, their list and each index's slot."""
    s, l = min(h, w), max(h, w)
    cap = min(n, s)
    lt, kt = _tiles.tile_counts(l, s)
    mt, _ = _tiles.tile_counts(cap, s)
    tile = _tiles.ROWS * _tiles.DEPTH
    return (b * (lt + mt) * kt * tile, b * mt * _tiles.ROWS * lt * _tiles.ROWS,
            b * (1 + cap + n))


def read_tail(derived: torch.Tensor, base: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 ``derived`` and ``base``, int64 flat indices ``idx``
    (n,) or (B, n) in [0, H W) -> (B, n) f32: the DEFAULT two-pass DCT of
    ``luma(derived - base)`` at the indices.

    CPU tensors take :func:`read_tail_reference`; CUDA tensors launch the
    kernel or raise. An index out of range raises: at once on the CPU; on
    the card as a device-side assert at the next synchronisation, as
    PyTorch's own indexing kernels do (checking at once would wait for the
    card), after which the process's CUDA context is unusable.
    """
    _check(derived, base, idx)
    h, w = derived.shape[1:3]
    if derived.device.type == "cpu":
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= h * w):
            raise ValueError(f"idx must lie in [0, {h * w})")
        count_rows("k5", idx, h, w, derived.shape[0])
        return read_tail_reference(derived, base, idx)
    out = _launch(derived, base, idx)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _launch(derived: torch.Tensor, base: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """The kernel's four launches on the current stream: (B, n) f32."""
    _check_image(derived, "derived")
    _check_image(base, "base")
    if derived.device.type != "cuda":
        raise ValueError(f"read_tail runs on CPU or CUDA, not "
                         f"{derived.device}")
    b, h, w = derived.shape[:3]
    n = idx.shape[-1]
    if idx.stride(-1) != 1:
        idx = idx.contiguous()
    # An index set shared by the batch (stride 0) is read once per image.
    idx_stride = idx.stride(0) if idx.ndim == 2 else 0
    dev = derived.device
    n_work, n_drows, n_meta = _layout(b, h, w, n)
    work = torch.empty(n_work, dtype=torch.bfloat16, device=dev)
    drows = torch.empty(n_drows, dtype=torch.bfloat16, device=dev)
    meta = torch.empty(n_meta, dtype=torch.int32, device=dev)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    basis_s = _basis_tiles(min(h, w), dev, Precision.DEFAULT)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.kernel("ssw_read_tail", _ARGTYPES)(
            derived.data_ptr(), base.data_ptr(), idx.data_ptr(), idx_stride,
            basis_s.data_ptr(), _long_basis(max(h, w), dev).data_ptr(),
            work.data_ptr(), n_work, drows.data_ptr(), n_drows,
            meta.data_ptr(), n_meta, out.data_ptr(), b, h, w, n,
            trace.row_total("k5", b, dev), stream)
    _build.check(code, "ssw_read_tail")
    return out


def _terms(derived: torch.Tensor, base: torch.Tensor, idx: torch.Tensor):
    """Per image, in f64 on the images' device, for landscape and portrait
    alike (S the shorter axis, L the longer, a_i and b_i the index's
    coordinates along them): ``(d, dabs, td, cl)``, each (n, L): the exact
    first-pass row ``D[i, l] = sum_s C_S[a_i, s] y(s, l)``, ``sum_s |C_S[a_i,
    s] y(s, l)|``, the plain version's bf16 first pass there, and
    ``C_L[b_i, l]``; bases and luma as the bf16 values the passes take."""
    h, w = derived.shape[1:3]
    land = h <= w
    idx = idx.expand(derived.shape[0], idx.shape[-1])
    rows, cols = idx // w, idx % w
    a_all, b_all = (rows, cols) if land else (cols, rows)
    plane = luma_pass_reference(derived, base)
    cs = dct.basis_tensor(min(h, w), derived.device,
                          torch.bfloat16).double()
    cl = dct.basis_tensor(max(h, w), derived.device,
                          torch.bfloat16).double()
    for i in range(derived.shape[0]):
        y = colorspace.luma_diff(base[i], derived[i]).to(
            torch.bfloat16).double()
        p = plane[i].double()
        if not land:
            y, p = y.t(), p.t()
        ca = cs[a_all[i]]
        yield (ca @ y, ca.abs() @ y.abs(), p[a_all[i]], cl[b_all[i]])


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    mag = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def k5_bound(derived: torch.Tensor, base: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """(B, n) f64: how far the kernel may lie from its plain version at
    each index (landscape; the mirror in portrait):

        sum_w |C_w[c_i, w]| (ulp(td[r_i, w]) + 2H u sum_h |C_h[r_i, h] y[h, w]|)
            + 2W u sum_w |td[r_i, w] C_w[c_i, w]|,       u = 2^-24,

    one bf16 rounding of a first-pass sum taken in another order (K1's own
    bound, carried through the dot; its ulp taken at |td| grown by that
    sum's error, for a rounding into the next binade), then an f32 dot
    taken in another order."""
    s, l = min(derived.shape[1:3]), max(derived.shape[1:3])
    out = []
    for _, dabs, td, cl in _terms(derived, base, idx):
        first = 2 * s * _U * dabs
        ulp = _bf16_ulp(td.abs() + first)
        out.append((cl.abs() * (ulp + first)).sum(-1)
                   + 2 * l * _U * (td * cl).abs().sum(-1))
    return torch.stack(out) if out else torch.zeros(
        (0, idx.shape[-1]), dtype=torch.float64, device=derived.device)


def f64_error(out: torch.Tensor, derived: torch.Tensor, base: torch.Tensor,
              idx: torch.Tensor) -> float:
    """The largest error of ``out`` (:func:`read_tail` of the same
    arguments, or its plain version's) against the f64 read whose first
    pass is rounded to bf16 once from its exact value, ``sum_l bf16(D[i,
    l]) C_L[b_i, l]``, in units of ``2^-24 (sum_l |C_L| sum_s |C_S y| +
    sum_l |D C_L|)``, the scale of both f32 sums' errors. 0 where every
    first-pass value is the correctly rounded one and the dot is exact; a
    first-pass sum that falls by a tie and rounds the other way counts
    one bf16 ulp, so the kernel's number reads beside its plain version's."""
    worst = 0.0
    for i, (d, dabs, _, cl) in enumerate(_terms(derived, base, idx)):
        exact = (d.to(torch.bfloat16).double() * cl).sum(-1)
        unit = _U * ((cl.abs() * dabs).sum(-1) + (d * cl).abs().sum(-1))
        err = (out[i].double() - exact).abs()
        worst = max(worst, float((err / unit.clamp_min(1e-300)).max()))
    return worst


def gates(out: torch.Tensor, derived: torch.Tensor, base: torch.Tensor,
          idx: torch.Tensor) -> dict:
    """The two gates K5's result ``out`` must pass, and their readings:
    within :func:`k5_bound` of the plain version at every index
    (``within_bound``), and an f64 error (:func:`f64_error`) at most twice
    the plain version's plus one unit (``within_f64``). The kernel's sums
    are shorter than the plain version's, so it reads the once-rounded f64
    value no worse; the factor and the unit leave room for a first-pass
    value that rounds the other way in one and not the other. The second
    gate catches what the first, which grows with the length of the dot,
    lets through at small sizes: a first pass not rounded to bf16, a luma
    operand in a narrower type."""
    ref = read_tail_reference(derived, base, idx)
    bound = k5_bound(derived, base, idx)
    d = (out.double() - ref.double()).abs()
    kernel, plain = (f64_error(x, derived, base, idx) for x in (out, ref))
    return {"share_bit_equal": float((d == 0).double().mean()),
            "max_abs_err": float(d.max()),
            "max_share_of_bound_used": float(
                (d / bound.clamp_min(1e-300)).max()),
            "kernel_f64_err": kernel, "plain_f64_err": plain,
            "within_bound": bool((d <= bound).all()),
            "within_f64": kernel <= 2 * plain + 1,
            "finite": bool(out.isfinite().all())}
