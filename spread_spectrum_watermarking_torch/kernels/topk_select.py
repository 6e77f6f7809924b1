"""K3: the exact top-n of every row, in (key desc, position asc) order.

Replaces the fast tiers' selection on the TPU, the JAX package's
``ops/ranking.py:approx_top_indices``, whose ``lax.approx_max_k`` calls
(:235, :246, :263, :274) lower to the TPU's PartialReduce unit: selection
done by hardware, with no ``pallas_call``. The port selects exactly, with
the reference's tie rule, and this kernel carries every exact top-n of the
port on the card:

- :func:`top_by_key` takes int32 keys and their positions ``pos``.
  Generation 1's and the custom metric's selection and re-sort, LEGACY's
  and ``exact_only``'s HIGHEST selection and ``parallel/topk_sharded.py``
  call it through ``ops.ranking._top_by_key``.
- :func:`top_of_plane` takes the fast tiers' bf16 plane, builds the 16-bit
  keys in registers, as :func:`plane_keys` builds them, and returns
  generation 2's whole selection: the indices in the re-sort's order and
  the f32 estimates there.
- :func:`top_of_coeffs` takes HIGHEST's f32 coefficient plane and builds
  ``_f32_key(ranking_metric(v))`` in registers (ENERGY,
  ENERGY_ORTHOGONAL): ``ops.ranking.top_indices`` on the card.

For n up to :data:`CAP` a call is two launches that read the input once;
above it, the multi-pass path. The CUDA source, ``csrc/topk_select.cu``,
says what bounds it on the H100 and how its design answers that. The
``*_reference`` functions are the plain versions: the CPU path, and what
the kernel is held against, index for index (estimates bit for bit), on
the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import Ordering
from . import _build

#: Launches of :func:`top_by_key`'s kernel in this process (plain-version
#: calls excluded).
LAUNCHES = 0
#: Launches of :func:`top_of_plane`'s kernel.
PLANE_LAUNCHES = 0
#: Launches of :func:`top_of_coeffs`'s kernel.
COEFF_LAUNCHES = 0
#: The device launches (kernels started on the stream) of the last K3 call.
LAST_DEVICE_LAUNCHES = 0
#: The largest n of the two-stage path: two launches, one read of the input.
CAP = 4096

_IDX_MAX = 2 ** 31 - 1
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_I, _P, _P, _I, _L, _L, _I, _I, _F, _F, _F, _F, _P, _P, _P, _P,
             _P]
_PLANE_MODES = {Ordering.ENERGY: 1, Ordering.ENERGY_ORTHOGONAL: 2,
                Ordering.LEGACY: 3}
_COEFF_MODES = {Ordering.ENERGY: 4, Ordering.ENERGY_ORTHOGONAL: 5}
_entry = None
_launched = ctypes.c_int(0)


def scale_factors(height: int, width: int) -> tuple:
    """The four f32 factors of ``ops.ranking._ortho_scale_map``: row 0's
    and the other rows' (``sqrt(1/4W)``, ``sqrt(1/2W)``), column 0's and
    the other columns' (``sqrt(1/4H)``, ``sqrt(1/2H)``). The kernel
    multiplies the pair of an element's row and column in f32, as
    ``_flat_scale(h, w)`` holds it, and rounds the product to bf16 for the
    plane's keys."""
    return tuple(np.float32(np.sqrt(1.0 / (k * d)))
                 for d in (width, height) for k in (4.0, 2.0))


def top_by_key_reference(key: torch.Tensor, pos: torch.Tensor | None,
                         n: int) -> torch.Tensor:
    """Plain version of :func:`top_by_key`: one unique int64 composite per
    element, ``(key << 32) | (2^31 - 1 - pos)``, makes ``torch.topk`` (not
    tie-stable by itself) deterministic."""
    if pos is None:
        pos = torch.arange(key.shape[-1], device=key.device,
                           dtype=torch.int64)
    comp = (key.to(torch.int64) << 32) | (_IDX_MAX - pos)
    return torch.topk(comp, n, dim=-1, sorted=True).indices


def top_by_key(key: torch.Tensor, pos: torch.Tensor | None,
               n: int) -> torch.Tensor:
    """Positions along the last axis (..., n) int64 of the n largest int32
    ``key``s (..., L), ordered by key descending, then ``pos`` ascending.

    ``pos`` is int64 (L,) or (..., L), unique within a row and in
    [0, 2^31), or None for the positions themselves. It need not be an
    arange: generation 1's re-sort passes the selected flat indices, the
    tiled selection tile-ordered candidates, the distributed top-k global
    indices, so ties at the threshold are broken by ``pos``.

    CPU tensors take :func:`top_by_key_reference`; CUDA tensors launch the
    kernel or raise.
    """
    if key.device.type == "cpu":
        return top_by_key_reference(key, pos, n)
    if key.dtype != torch.int32 or key.ndim < 1:
        raise ValueError(f"key must be (..., L) int32, got "
                         f"{tuple(key.shape)} {key.dtype}")
    length = key.shape[-1]
    if pos is not None:
        if pos.dtype != torch.int64 or tuple(pos.shape) not in (
                (length,), tuple(key.shape)):
            raise ValueError(f"pos must be int64 ({length},) or "
                             f"{tuple(key.shape)}, got {tuple(pos.shape)} "
                             f"{pos.dtype}")
        if pos.device != key.device:
            raise ValueError("key and pos must be on one device")
        if not pos.is_contiguous():
            raise ValueError("pos must be contiguous")
    out, _, launched = _launch(0, key, pos, n, length)
    global LAUNCHES
    LAUNCHES += launched
    return out


def plane_keys(plane: torch.Tensor, ordering: Ordering) -> torch.Tensor:
    """The fast tiers' int32 keys (..., H*W) of a bf16 plane (..., H, W):
    ENERGY and ENERGY_ORTHOGONAL ``(bits(|s|) & 0xFFFE) | signbit(s)``,
    LEGACY the bf16 order key of ``s``, with ``s`` the value (ENERGY) or
    its product with the bf16 ortho scale; DC forced to ``_DC_KEY``. Bit
    for bit the JAX package's keys (``ranking.py:256-273``)."""
    from ..ops import ranking

    h, w = plane.shape[-2], plane.shape[-1]
    flat_c = plane.reshape(*plane.shape[:-2], h * w)
    if ordering == Ordering.ENERGY:
        scaled = flat_c
    else:
        scale = ranking._flat_scale(h, w, flat_c.device).to(torch.bfloat16)
        scaled = flat_c * scale
    if ordering == Ordering.LEGACY:
        key = ranking._bf16_key(scaled)
    elif ordering in (Ordering.ENERGY, Ordering.ENERGY_ORTHOGONAL):
        sgn = torch.signbit(scaled).to(torch.int32)
        key = (ranking._bits16(torch.abs(scaled)) & 0xFFFE) | sgn
    else:
        raise ValueError(f"unknown ordering {ordering}")
    key[..., 0] = ranking._DC_KEY
    return key


def plane_set_reference(plane: torch.Tensor, n: int, ordering: Ordering
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The set :func:`top_of_plane` selects, in its selection order:
    :func:`plane_keys`, :func:`top_by_key_reference` over the flat indices,
    and the keys gathered there: ``(idx, keys)``."""
    key = plane_keys(plane, ordering)
    idx = top_by_key_reference(key, None, n)
    return idx, torch.gather(key, -1, idx)


def _from_bits16(bits: torch.Tensor) -> torch.Tensor:
    """int32 holding 16 bf16 bits -> f32 value."""
    return bits.to(torch.int16).view(torch.bfloat16).to(torch.float32)


def resort_reference(idx: torch.Tensor, kv: torch.Tensor, height: int,
                     width: int, ordering: Ordering
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Generation 2's tail after the select, as plain ops: the signed bf16
    estimates rebuilt from the keys ``kv`` at ``idx`` (the LSB-stored sign
    for ENERGY and ENERGY_ORTHOGONAL, the order key's bits for LEGACY),
    divided by the f32 ortho scale except at ENERGY, 0.0 at DC; then the
    re-sort by (LSB-masked key desc, index asc; LEGACY's key unmasked; DC
    last): ``(indices, estimates)`` in rank order."""
    from ..ops import ranking

    if ordering == Ordering.LEGACY:
        order_key = kv
        bits = torch.where(kv < 0, (-kv) | 0x8000, kv)
        sval = _from_bits16(bits)
    else:
        mag_bits = kv & 0xFFFE
        order_key = mag_bits
        mag = _from_bits16(mag_bits)
        sval = torch.where((kv & 1) != 0, -mag, mag)
    order_key = torch.where(idx == 0, ranking._DC_KEY, order_key)
    # DC's estimate is 0.0, not a value that poisons Option2/3 divisions.
    sval = torch.where(idx == 0, 0.0, sval)
    if ordering == Ordering.ENERGY:
        cand_c = sval
    else:
        cand_c = sval / ranking._flat_scale(height, width, idx.device)[idx]
    resort = top_by_key_reference(order_key, idx, idx.shape[-1])
    return torch.gather(idx, -1, resort), torch.gather(cand_c, -1, resort)


def top_of_plane_reference(plane: torch.Tensor, n: int, ordering: Ordering
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`top_of_plane`: :func:`plane_set_reference`,
    then :func:`resort_reference`."""
    idx, kv = plane_set_reference(plane, n, ordering)
    return resort_reference(idx, kv, plane.shape[-2], plane.shape[-1],
                            ordering)


def top_of_plane(plane: torch.Tensor, n: int, ordering: Ordering
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Generation 2's selection over a bf16 plane (..., H, W): the n largest
    keys under ``ordering`` (:func:`plane_keys`, ties by flat index), in the
    re-sort's order (:func:`resort_reference`): ``(idx, est)``, the flat
    indices (..., n) int64 and the f32 estimates there. On the card one K3
    call builds the keys in registers and never stores them.

    CPU tensors take :func:`top_of_plane_reference`; CUDA tensors launch
    the kernel or raise.
    """
    if ordering not in _PLANE_MODES:
        raise ValueError(f"unknown ordering {ordering}")
    if plane.device.type == "cpu":
        return top_of_plane_reference(plane, n, ordering)
    if plane.dtype != torch.bfloat16 or plane.ndim < 2:
        raise ValueError(f"plane must be (..., H, W) bfloat16, got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    h, w = plane.shape[-2], plane.shape[-1]
    out, est, launched = _launch(_PLANE_MODES[ordering], plane, None, n,
                                 h * w, w, scale_factors(h, w))
    global PLANE_LAUNCHES
    PLANE_LAUNCHES += launched
    return out, est


def top_of_coeffs_reference(coeffs: torch.Tensor, n: int, ordering: Ordering
                            ) -> torch.Tensor:
    """Plain version of :func:`top_of_coeffs`: the f32 metric plane
    (``ops.ranking.ranking_metric``), its int32 total-order keys
    (``_f32_key``), DC set to the key of -inf, then
    :func:`top_by_key_reference`."""
    from ..ops import ranking

    h, w = coeffs.shape[-2], coeffs.shape[-1]
    metric = ranking.ranking_metric(coeffs.to(torch.float32), ordering)
    key = ranking._f32_key(
        metric.reshape(*coeffs.shape[:-2], h * w).contiguous())
    key[..., 0] = ranking._NEG_INF_KEY
    return top_by_key_reference(key, None, n)


def top_of_coeffs(coeffs: torch.Tensor, n: int, ordering: Ordering
                  ) -> torch.Tensor:
    """Flat indices (..., n) int64 of the n strongest coefficients of an f32
    plane (..., H, W) under ENERGY or ENERGY_ORTHOGONAL, DC excluded, by
    (metric desc, index asc): HIGHEST's exact selection. On the card the
    f32 total-order keys of the metric are built in registers from one
    read of the plane, so neither the metric plane nor the key plane is
    written.

    CPU tensors take :func:`top_of_coeffs_reference`; CUDA tensors launch
    the kernel or raise.
    """
    if ordering not in _COEFF_MODES:
        raise ValueError(f"top_of_coeffs takes ENERGY or ENERGY_ORTHOGONAL, "
                         f"not {ordering}")
    if coeffs.device.type == "cpu":
        return top_of_coeffs_reference(coeffs, n, ordering)
    if coeffs.dtype != torch.float32 or coeffs.ndim < 2:
        raise ValueError(f"coeffs must be (..., H, W) float32, got "
                         f"{tuple(coeffs.shape)} {coeffs.dtype}")
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    out, _, launched = _launch(_COEFF_MODES[ordering], coeffs, None, n,
                               h * w, w, scale_factors(h, w))
    global COEFF_LAUNCHES
    COEFF_LAUNCHES += launched
    return out


@functools.lru_cache(maxsize=256)
def _workspace(device: int, mode: int, has_pos: bool, rows: int,
               length: int, n: int) -> int:
    """Scratch bytes of one call, per device (the split into chunks follows
    its SM count) and shape."""
    return _build.library().ssw_topk_select_workspace(mode, int(has_pos),
                                                      rows, length, n)


def _launch(mode: int, src: torch.Tensor, pos: torch.Tensor | None, n: int,
            length: int, width: int = 0, scales=(0.0,) * 4):
    """Checks what every mode shares, allocates the outputs and the scratch
    (from the caching allocator, one block per call) and launches
    ``ssw_topk_select``: ``(positions, estimates or None, launched)``;
    nothing is launched for an empty output."""
    global _entry, LAST_DEVICE_LAUNCHES
    if src.device.type != "cuda":
        raise ValueError(f"top-n selection runs on CPU or CUDA, not "
                         f"{src.device}")
    if not src.is_contiguous():
        raise ValueError("the keys or the plane must be contiguous")
    if not 0 <= n <= length:
        raise ValueError(f"n must be in [0, {length}], got {n}")
    if length >= 2 ** 31:
        raise ValueError(f"rows of {length} elements are longer than the "
                         "kernel's 2^31")
    rows = src.numel() // length if length else 0
    lead = src.shape[:-2] if mode else src.shape[:-1]
    out = torch.empty((*lead, n), device=src.device, dtype=torch.int64)
    est = (torch.empty_like(out, dtype=torch.float32) if mode in (1, 2, 3)
           else None)
    LAST_DEVICE_LAUNCHES = 0
    if rows == 0 or n == 0:
        return out, est, False
    if _entry is None:
        _entry = _build.kernel("ssw_topk_select", _ARGTYPES)
    dev = src.device.index
    with torch.cuda.device(dev):
        scratch = torch.empty(
            _workspace(dev, mode, pos is not None, rows, length, n),
            device=src.device, dtype=torch.uint8)
        code = _entry(mode, src.data_ptr(),
                      None if pos is None else pos.data_ptr(),
                      int(pos is not None and pos.ndim > 1), rows, length,
                      width, n, *(float(s) for s in scales),
                      scratch.data_ptr(), out.data_ptr(),
                      None if est is None else est.data_ptr(),
                      ctypes.addressof(_launched),
                      torch.cuda.current_stream().cuda_stream)
    _build.check(code, "ssw_topk_select")
    LAST_DEVICE_LAUNCHES = _launched.value
    return out, est, True
