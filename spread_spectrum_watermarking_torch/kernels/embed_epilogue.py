"""K4: sparse inverse DCT of the coefficient update, added to u8 RGB.

Replaces the TPU kernel ``embed_epilogue`` (``ops/fused_dct.py`` of the JAX
package, ``pallas_call`` at :446, removed in 6b7c109) and takes what it
took: the u8 image, the n updates ``delta`` and their flat indices ``idx``.
The CUDA source, ``csrc/embed_epilogue.cu``, says what bounds it on the
H100 and how its design answers that. :func:`embed_epilogue_reference` is
its plain version: the CPU path, and what the kernel is held against on the
card.

The kernel is two launches. The first writes the bf16 factors of
``ops.dct.sparse_idct_factors``, ``a`` as (H, n) and ``b`` as (W, n), as
the tile images of ``_tiles`` into the wrapper's scratch (every image's
``a``, then every image's ``b``); :func:`factor_tiles` runs it alone and
:func:`factor_tiles_reference` is its plain version. The second multiplies
them, ``dY[h, w] = bf16(sum_k a[h, k] b[w, k])`` (f32 sums), and adds dY to
the image as ``colorspace.add_luma_delta_u8`` does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import colorspace, dct
from . import _build, _tiles
from .dct2d_fused import inverse_scale

#: Launches of the CUDA kernel in this process (plain-version calls excluded).
LAUNCHES = 0
#: Launches of the factor tile pass alone (:func:`factor_tiles`).
FACTOR_LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FACTOR_ARGTYPES = [_P, _P, _P, _P, ctypes.c_float, _P, _L, _I, _I, _I, _I,
                    _P]
_ARGTYPES = [_P, _P, _P, _P, _P, ctypes.c_float, _P, _L, _P, _I, _I, _I, _I,
             _P]


def delta_plane(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dY (B, H, W) bf16 from the k-major factors: the plain product."""
    return dct.matmul_bf16(a.transpose(-1, -2), b)


def embed_epilogue_reference(rgb: torch.Tensor, delta: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`embed_epilogue`."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    return colorspace.add_luma_delta_u8(
        rgb, delta_plane(*dct.sparse_idct_factors(delta, idx, h, w)))


def factor_tiles_reference(delta: torch.Tensor, idx: torch.Tensor, h: int,
                           w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`factor_tiles`: the tile images of the bf16
    factors as (B, H, n) and (B, W, n), (B, rt, kt, ROWS, DEPTH) each."""
    a, b = dct.sparse_idct_factors(delta, idx, h, w)
    return (_tiles.tile_image(a.transpose(-1, -2)),
            _tiles.tile_image(b.transpose(-1, -2)))


def _layout(bsz: int, h: int, w: int, n: int) -> tuple[tuple, tuple]:
    """The shapes of the scratch's two tile images, ``a``'s then ``b``'s."""
    rt_a, kt = _tiles.tile_counts(h, n)
    rt_b, _ = _tiles.tile_counts(w, n)
    tile = (_tiles.ROWS, _tiles.DEPTH)
    return (bsz, rt_a, kt, *tile), (bsz, rt_b, kt, *tile)


@functools.lru_cache(maxsize=16)
def _inverse_rows(n: int, device: torch.device) -> torch.Tensor:
    """The f32 inverse DCT basis of size n, transposed: row u is the basis
    column that coefficient row (or column) u contributes."""
    return dct.basis_tensor(n, device, torch.float32,
                            inverse=True).t().contiguous()


def _check(delta: torch.Tensor, idx: torch.Tensor) -> None:
    if delta.dtype != torch.float32 or delta.ndim != 2:
        raise ValueError(f"delta must be (B, n) float32, got "
                         f"{tuple(delta.shape)} {delta.dtype}")
    if idx.dtype != torch.int64 or idx.shape != delta.shape:
        raise ValueError(f"idx must be int64 {tuple(delta.shape)}, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != delta.device:
        raise ValueError("delta and idx must be on one device")


def _launch(delta: torch.Tensor, idx: torch.Tensor, h: int, w: int,
            rgb: torch.Tensor | None):
    """The factor pass, and with ``rgb`` the product and its epilogue:
    ``(scratch, out)``."""
    for name, t in (("delta", delta), ("idx", idx), ("rgb", rgb)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if delta.device.type != "cuda":
        raise ValueError(f"embed_epilogue runs on CPU or CUDA, not "
                         f"{delta.device}")
    bsz, n = delta.shape
    shapes = _layout(bsz, h, w, n)
    n_work = sum(torch.Size(s).numel() for s in shapes)
    work = torch.empty(n_work, dtype=torch.bfloat16, device=delta.device)
    dht, dwt = _inverse_rows(h, delta.device), _inverse_rows(w, delta.device)
    common = (delta.data_ptr(), idx.data_ptr(), dht.data_ptr(),
              dwt.data_ptr(), inverse_scale(h, w), work.data_ptr(), n_work)
    out = None
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream().cuda_stream
        if rgb is None:
            name = "ssw_embed_factor_tiles"
            code = _build.kernel(name, _FACTOR_ARGTYPES)(
                *common, bsz, h, w, n, stream)
        else:
            name = "ssw_embed_epilogue"
            out = torch.empty_like(rgb)
            code = _build.kernel(name, _ARGTYPES)(
                rgb.data_ptr(), *common, out.data_ptr(), bsz, h, w, n, stream)
    _build.check(code, name)
    return work, out


def factor_tiles(delta: torch.Tensor, idx: torch.Tensor, h: int,
                 w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's first launch alone, for checking it: the tile images of
    the factors of ``(delta, idx)`` on an (h, w) image, as
    :func:`factor_tiles_reference` returns them.

    CPU tensors take :func:`factor_tiles_reference`; CUDA tensors launch
    the factor pass or raise.
    """
    _check(delta, idx)
    if delta.device.type == "cpu":
        return factor_tiles_reference(delta, idx, h, w)
    work, _ = _launch(delta, idx, h, w, None)
    global FACTOR_LAUNCHES
    FACTOR_LAUNCHES += 1
    sa, sb = _layout(delta.shape[0], h, w, delta.shape[1])
    na = torch.Size(sa).numel()
    return work[:na].view(sa), work[na:].view(sb)


def embed_epilogue(rgb: torch.Tensor, delta: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 + the sparse inverse DCT of updates ``delta`` (B, n)
    f32 at flat indices ``idx`` (B, n) int64 (each in [0, H W)) -> u8.

    CPU tensors take :func:`embed_epilogue_reference`; CUDA tensors launch
    the kernel or raise.
    """
    if rgb.dtype != torch.uint8 or rgb.ndim != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb must be (B, H, W, 3) uint8, got "
                         f"{tuple(rgb.shape)} {rgb.dtype}")
    _check(delta, idx)
    if delta.shape[0] != rgb.shape[0]:
        raise ValueError(f"delta has {delta.shape[0]} images, rgb "
                         f"{rgb.shape[0]}")
    if delta.device != rgb.device:
        raise ValueError("rgb, delta and idx must be on one device")
    if rgb.device.type == "cpu":
        return embed_epilogue_reference(rgb, delta, idx)
    if rgb.numel() == 0:
        return rgb.clone()
    _, out = _launch(delta, idx, rgb.shape[1], rgb.shape[2], rgb)
    global LAUNCHES
    LAUNCHES += 1
    return out
