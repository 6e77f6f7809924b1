"""The tile image of an operand, as the Hopper mainloop reads it.

``csrc/wgmma_tile.cuh`` takes each operand of its products as a matrix
``X[r][k]`` (k the contracted axis) cut into tiles of ``ROWS x DEPTH`` bf16
(128 x 64, 16 KB), tile ``(rt, kt)`` at ``(rt * ktiles + kt) * ROWS *
DEPTH``, each in wgmma's K-major layout with the 128-byte swizzle: row r of
a tile is 128 bytes, and its 16-byte chunk c (8 values) lies at chunk
``c ^ (r % 8)``. Zeros fill the tiles past X's edges. One stage of the
mainloop is then one contiguous copy. :func:`tile_image` builds that layout
on the host for the DCT bases (cached by the kernel wrappers); the kernels
write their transformed operand in the same layout on the card.
"""

from __future__ import annotations

import torch

ROWS = 128   # rows of a tile (csrc/wgmma_tile.cuh kRows)
DEPTH = 64   # k of a tile (kDepth)
_CHUNK = 8   # bf16 values in a 16-byte chunk


def tile_counts(rows: int, depth: int) -> tuple[int, int]:
    """(row tiles, k tiles) of an operand of ``rows`` rows and ``depth`` k."""
    return -(-rows // ROWS), -(-depth // DEPTH)


def _chunk_order(device: torch.device) -> torch.Tensor:
    """(ROWS, 8): the chunk of X that lies at chunk position j of row r."""
    r = torch.arange(ROWS, device=device)[:, None]
    j = torch.arange(DEPTH // _CHUNK, device=device)[None, :]
    return j ^ (r % 8)


def tile_image(x: torch.Tensor) -> torch.Tensor:
    """(..., R, K) -> (..., rt, kt, ROWS, DEPTH) bf16: X's tile image."""
    *lead, rows, depth = x.shape
    rt, kt = tile_counts(rows, depth)
    t = torch.nn.functional.pad(x.to(torch.bfloat16),
                                (0, kt * DEPTH - depth, 0, rt * ROWS - rows))
    t = t.reshape(*lead, rt, ROWS, kt, DEPTH).transpose(-3, -2)
    chunks = t.reshape(*lead, rt, kt, ROWS, DEPTH // _CHUNK, _CHUNK)
    r = torch.arange(ROWS, device=x.device)[:, None]
    return chunks[..., r, _chunk_order(x.device), :].reshape(
        *lead, rt, kt, ROWS, DEPTH).contiguous()


def untile_image(t: torch.Tensor, rows: int, depth: int) -> torch.Tensor:
    """The inverse of :func:`tile_image`: (..., rt, kt, ROWS, DEPTH) ->
    (..., rows, depth)."""
    *lead, rt, kt, _, _ = t.shape
    chunks = t.reshape(*lead, rt, kt, ROWS, DEPTH // _CHUNK, _CHUNK)
    r = torch.arange(ROWS, device=t.device)[:, None]
    # Chunk c of row r lies at position c ^ (r % 8): the same permutation.
    x = chunks[..., r, _chunk_order(t.device), :].reshape(
        *lead, rt, kt, ROWS, DEPTH).transpose(-3, -2)
    return x.reshape(*lead, rt * ROWS, kt * DEPTH)[..., :rows, :depth]
