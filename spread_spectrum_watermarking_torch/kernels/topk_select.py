"""K3: the exact top-n of every row, in (key desc, position asc) order.

Replaces the fast tiers' selection on the TPU, the JAX package's
``ops/ranking.py:approx_top_indices``, whose ``lax.approx_max_k`` calls
(:235, :246, :263, :274) lower to the TPU's PartialReduce unit: selection
done by hardware, with no ``pallas_call``. The port selects exactly, with
the reference's tie rule, and this kernel carries every exact top-n of the
port on the card:

- :func:`top_by_key` takes int32 keys and their positions ``pos``. The
  generation-2 re-sort, generation 1 and the custom metric, the HIGHEST
  selection and ``parallel/topk_sharded.py`` call it through
  ``ops.ranking._top_by_key``.
- :func:`top_of_plane` takes the fast tiers' bf16 plane and builds the
  16-bit keys in registers, as :func:`plane_keys` builds them. It is the
  generation-2 selection.

The CUDA source, ``csrc/topk_select.cu``, says what bounds it on the H100
and how its design answers that. :func:`top_by_key_reference` and
:func:`top_of_plane_reference` are the plain versions: the CPU path, and
what the kernel is held against, index for index, on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import Ordering
from . import _build

#: Launches of :func:`top_by_key`'s kernel in this process (plain-version
#: calls excluded).
LAUNCHES = 0
#: Launches of :func:`top_of_plane`'s kernel.
PLANE_LAUNCHES = 0

_IDX_MAX = 2 ** 31 - 1
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_I, _P, _P, _I, _L, _L, _I, _I, _F, _F, _F, _F, _P, _P, _P, _P]
_PLANE_MODES = {Ordering.ENERGY: 1, Ordering.ENERGY_ORTHOGONAL: 2,
                Ordering.LEGACY: 3}


def scale_factors(height: int, width: int) -> tuple:
    """The four f32 factors of ``ops.ranking._ortho_scale_map``: row 0's
    and the other rows' (``sqrt(1/4W)``, ``sqrt(1/2W)``), column 0's and
    the other columns' (``sqrt(1/4H)``, ``sqrt(1/2H)``). The kernel
    multiplies the pair of an element's row and column in f32 and rounds
    the product to bf16, as ``_flat_scale(h, w).to(bf16)`` holds it."""
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
    arange: the re-sort passes the selected flat indices, the tiled
    selection tile-ordered candidates, the distributed top-k global
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


def top_of_plane_reference(plane: torch.Tensor, n: int, ordering: Ordering
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`top_of_plane`: :func:`plane_keys`, then
    :func:`top_by_key_reference` over the flat indices, and the keys
    gathered there."""
    key = plane_keys(plane, ordering)
    idx = top_by_key_reference(key, None, n)
    return idx, torch.gather(key, -1, idx)


def top_of_plane(plane: torch.Tensor, n: int, ordering: Ordering
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The n largest keys of a bf16 plane (..., H, W) under ``ordering``
    (:func:`plane_keys`), DC last: ``(idx, keys)``, the flat indices
    (..., n) int64 in (key desc, index asc) order and the int32 keys at
    them. On the card the keys are built in registers from one read of the
    plane per pass and never stored.

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
    out, keys, launched = _launch(_PLANE_MODES[ordering], plane, None, n,
                                  h * w, w, scale_factors(h, w))
    global PLANE_LAUNCHES
    PLANE_LAUNCHES += launched
    return out, keys


def _launch(mode: int, src: torch.Tensor, pos: torch.Tensor | None, n: int,
            length: int, width: int = 0, scales=(0.0,) * 4):
    """Checks what every mode shares, allocates the outputs and the scratch
    and launches ``ssw_topk_select``: ``(positions, keys or None,
    launched)``; nothing is launched for an empty output."""
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
    keys = torch.empty_like(out, dtype=torch.int32) if mode else None
    if rows == 0 or n == 0:
        return out, keys, False
    lib = _build.library()
    lib.ssw_topk_select_workspace.argtypes = [_L, _L, _I]
    lib.ssw_topk_select_workspace.restype = _L
    scratch = torch.empty(lib.ssw_topk_select_workspace(rows, length, n),
                          device=src.device, dtype=torch.uint8)
    fn = _build.kernel("ssw_topk_select", _ARGTYPES)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        pos_ptr = None if pos is None else pos.data_ptr()
        code = fn(mode, src.data_ptr(), pos_ptr,
                  int(pos is not None and pos.ndim > 1), rows, length, width,
                  n, *(float(s) for s in scales), scratch.data_ptr(),
                  out.data_ptr(), None if keys is None else keys.data_ptr(),
                  stream)
    _build.check(code, "ssw_topk_select")
    return out, keys, True
