"""Sharded end-to-end pipelines: DP over image batches, TP over one huge image.

Port of the JAX package's ``parallel/pipeline_sharded.py``. Every rank
calls an entry point with the same global host input; each places only its
own block on its device (``mesh.place``) and returns its own block of the
result, in the layout of the JAX function's ``out_specs``; values JAX
replicates (the extracted marks of ``extract_spatial``) are the same on
every rank. ``mesh.gather`` rebuilds a global result.

- :func:`embed_batch_sharded` / :func:`extract_batch_sharded`: data
  parallel. Each rank runs ``models.pipeline.embed``/``extract`` on its
  block of the batch, so the tier's kernels run on every rank (K1 and K4
  at the fast tiers, K6a and K7 at HIGHEST).

- :func:`embed_spatial` / :func:`extract_spatial`: tensor (spatial)
  parallel for one image too large for one device: the sharded DCT's
  all-to-all (``dct_sharded``) plus the distributed top-k
  (``topk_sharded``), with the modulation run on every rank on the
  gathered top-n values and each rank writing back the updates it owns.

- :func:`embed_corpus` / :func:`extract_corpus`: joint DP x TP for a
  corpus of images each too large for one device (BASELINE config 5): the
  batch over ``data``, each image's rows over ``spatial``. The forward
  transform is the sharded DCT (one all-to-all per pass); the inverse is a
  local sparse delta-IDCT: once the distributed top-k has given every
  spatial rank the (n,) indices and deltas, each rank builds dY for its
  own rows with one (Hl, n) @ (n, W) product, and the write-back
  ``clip(rgb/255 + dY) -> u8`` is kernel K7's u8 mode on the card
  (``kernels.add_quantize``), its plain version on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import ReadConfig, WriteConfig
from ..kernels.add_quantize import add_quantize
from ..kernels.dct2d_fused import inverse_scale
from ..models import pipeline
from ..ops import colorspace, dct, modulation
from .dct_sharded import (_pad_last2, dct2_2d_sharded_padded,
                          idct2_2d_sharded_padded)
from .mesh import DATA_AXIS, SPATIAL_AXIS, Local, Mesh, padded_size, place
from .topk_sharded import distributed_top_indices


# ---------------------------------------------------------------------------
# Data-parallel batch pipelines
# ---------------------------------------------------------------------------


def _place_marks(marks, mesh: Mesh) -> torch.Tensor:
    """Per-image (B, M, N) marks follow the batch; shared ones are whole."""
    if np.ndim(marks) == 3:
        return place(marks, mesh, {0: DATA_AXIS})
    return place(marks, mesh)


def embed_batch_sharded(rgb, marks, mesh: Mesh,
                        config: WriteConfig = WriteConfig(), quantize=True):
    """DP embed: this rank's (B/d, H, W, 3) block of ``pipeline.embed`` of
    the (B, H, W, 3) images, B divisible by the data axis size d."""
    rgb = place(rgb, mesh, {0: DATA_AXIS})
    return pipeline.embed(rgb, _place_marks(marks, mesh), config,
                          quantize=quantize)


def extract_batch_sharded(base, derived, n: int, mesh: Mesh,
                          config: ReadConfig = ReadConfig()):
    """DP extract: this rank's (B/d, n) block of ``pipeline.extract``."""
    base = place(base, mesh, {0: DATA_AXIS})
    derived = place(derived, mesh, {0: DATA_AXIS})
    return pipeline.extract(base, derived, n, config)


# ---------------------------------------------------------------------------
# Spatial (tensor-parallel) single-image pipelines
# ---------------------------------------------------------------------------


def _owned(idx: torch.Tensor, width: int, wb: int, me: int):
    """``(mine, local_flat)``: which global flat indices fall in this
    rank's column block of width ``wb``, and their flat position there."""
    rows = torch.div(idx, width, rounding_mode="floor")
    cols = idx % width
    return cols // wb == me, rows * wb + (cols - me * wb)


def _gather_replicated(coef_blk: torch.Tensor, idx: torch.Tensor,
                       width: int, mesh: Mesh) -> torch.Tensor:
    """The (..., n) values at global flat ``idx`` from a (..., Hp, Wp/s)
    column block, the same on every spatial rank: each rank gathers the
    values it owns, zero elsewhere, and a psum combines them (x + 0 is
    exact)."""
    mine, local_flat = _owned(idx, width, coef_blk.shape[-1],
                              mesh.index(SPATIAL_AXIS))
    flat = coef_blk.reshape(*coef_blk.shape[:-2], -1)
    vals = torch.gather(flat, -1, torch.where(mine, local_flat, 0))
    return mesh.psum(torch.where(mine, vals, 0.0))


def _modulate_sharded(coef_blk: torch.Tensor, marks: torch.Tensor,
                      mesh: Mesh, config: WriteConfig, height: int,
                      width: int) -> torch.Tensor:
    """Top-k + modulation + scatter on a (Hp, Wp/s) column block."""
    n = marks.shape[-1]
    idx = distributed_top_indices(coef_blk, n, config.ordering, height,
                                  width, mesh)
    original = _gather_replicated(coef_blk, idx, width, mesh)
    new_values = modulation.embed_marks(
        original, marks, config.insertion.method, config.insertion.alpha,
        custom_insert=config.custom_insert, indices=idx)
    mine, local_flat = _owned(idx, width, coef_blk.shape[-1],
                              mesh.index(SPATIAL_AXIS))
    flat = coef_blk.reshape(-1).clone()
    flat[local_flat[mine]] = new_values[mine]
    return flat.reshape(coef_blk.shape)


def _place_row_sharded(img, mesh: Mesh) -> torch.Tensor:
    """This rank's row block of ``img``, rows zero-padded to a multiple of
    the spatial axis size: every rank holds Hp/s rows, never the whole
    image (a replicated fallback would bring back the per-device memory
    ceiling for exactly the images this path exists for)."""
    return place(img, mesh, {0: SPATIAL_AXIS}, pad=(0,))


def _crop_rows(x: torch.Tensor, mesh: Mesh, height: int) -> torch.Tensor:
    """This rank's row block cropped to the global height."""
    hl = x.shape[0]
    start = mesh.index(SPATIAL_AXIS) * hl
    return x[:max(0, min(hl, height - start))]


def embed_spatial(rgb, marks, mesh: Mesh,
                  config: WriteConfig = WriteConfig(), quantize=True):
    """TP embed of ONE (H, W, 3) image over the mesh's spatial axis.

    Any H x W is accepted (rows are zero-padded on the host and
    row-sharded, so no rank holds the whole image, mirroring the
    reference's arbitrary sizes, src/dct2d.rs:83-98). Returns this rank's
    row block of the (H, W, 3) result (the last block cropped); ranks that
    differ only on the data axis compute the same block.
    """
    marks = place(marks, mesh)
    if marks.ndim == 1:
        marks = marks[None]
    h, w = rgb.shape[0], rgb.shape[1]
    wp = padded_size(w, mesh.shape[SPATIAL_AXIS])
    blk = _place_row_sharded(rgb, mesh)
    yiq = colorspace.rgb_to_yiq(colorspace.to_f32(blk))
    # Pad the luma up to divisibility; the zero-extended bases keep the
    # padding inert, the top-k masks it, and the result is cropped.
    y_pad = _pad_last2(yiq[..., 0], blk.shape[0], wp)
    coeffs = dct2_2d_sharded_padded(y_pad, mesh, h, w,
                                    precision=config.precision)
    coeffs = _modulate_sharded(coeffs, marks, mesh, config, h, w)
    y = idct2_2d_sharded_padded(coeffs, mesh, h, w,
                                precision=config.precision)[..., :w]
    out = pipeline._with_luma(yiq, y)
    if quantize:
        out = colorspace.f32_to_u8(out)
    return _crop_rows(out, mesh, h)


def extract_spatial(base, derived, n: int, mesh: Mesh,
                    config: ReadConfig = ReadConfig()):
    """TP extract from ONE image pair over the mesh's spatial axis: the
    (n,) mark, the same on every rank."""
    if tuple(base.shape) != tuple(derived.shape):
        raise ValueError(
            "Derived coefficient length not equal to base coefficient length.")
    if n >= base.shape[0] * base.shape[1]:
        raise ValueError(
            "Desired extraction length exceeds available coefficients.")
    h, w = base.shape[0], base.shape[1]
    wp = padded_size(w, mesh.shape[SPATIAL_AXIS])
    planes = []
    for img in (base, derived):
        blk = _place_row_sharded(img, mesh)
        y = colorspace.rgb_to_yiq(colorspace.to_f32(blk))[..., 0]
        planes.append(dct2_2d_sharded_padded(
            _pad_last2(y, blk.shape[0], wp), mesh, h, w,
            precision=config.precision))
    cb, cd = planes
    idx = distributed_top_indices(cb, n, config.ordering, h, w, mesh)
    bvals = _gather_replicated(cb, idx, w, mesh)
    dvals = _gather_replicated(cd, idx, w, mesh)
    if config.custom_extract is not None:
        return config.custom_extract(idx, bvals, dvals)
    return modulation.extract_values(config.extraction.method,
                                     config.extraction.alpha, bvals, dvals)


# ---------------------------------------------------------------------------
# Joint DP x TP corpus pipelines (BASELINE config 5)
# ---------------------------------------------------------------------------


def _row_pass_to_columns(y: torch.Tensor, h: int, w: int, mesh: Mesh,
                         precision) -> torch.Tensor:
    """Local (Bl, Hp/s, W) plane -> (Bl, Hp, Wp/s) column-sharded
    coefficients: the row pass over W, one all-to-all over the spatial
    axis, the column pass over H."""
    wp = padded_size(w, mesh.shape[SPATIAL_AXIS])
    return dct2_2d_sharded_padded(_pad_last2(y, y.shape[-2], wp), mesh,
                                  h, w, precision=precision)


def _corpus_forward(rgb_blk: torch.Tensor, h: int, w: int, mesh: Mesh,
                    precision) -> torch.Tensor:
    """Local (Bl, Hp/s, W, 3) row block -> (Bl, Hp, Wp/s) coefficients of
    its luma; the batch axis rides along."""
    return _row_pass_to_columns(colorspace.luma(rgb_blk), h, w, mesh,
                                precision)


@functools.lru_cache(maxsize=16)
def _inverse_rows(h: int, hp: int, device: torch.device) -> torch.Tensor:
    """The inverse row basis ``dct3_basis(h)`` ([pixel, coeff]) with its
    PIXEL rows zero-extended over the padding rows (dY is 0 there)."""
    d = np.zeros((hp, h), np.float32)
    d[:h] = dct.dct3_basis(h)
    return torch.from_numpy(d).to(device)


def _place_corpus(imgs, mesh: Mesh) -> torch.Tensor:
    """This rank's (B/d, Hp/s, W, 3) block: the batch over the data axis,
    the rows, zero-padded to a multiple of the spatial axis size, over
    the spatial axis."""
    return place(imgs, mesh, {0: DATA_AXIS, 1: SPATIAL_AXIS}, pad=(1,))


def embed_corpus(rgb, marks, mesh: Mesh, config: WriteConfig = WriteConfig()):
    """Joint DP x TP embed of a corpus of huge images (BASELINE config 5).

    ``rgb``: (B, H, W, 3) with B divisible by the data axis; ``marks``:
    (B, n), one mark per image. Returns this rank's (B/d, Hp/s, W, 3) u8
    block of the padded (B, Hp, W, 3) result, whose rows >= H are zero;
    keeping the padded layout lets :func:`extract_corpus` take the block
    back as ``mesh.Local(block)`` without moving it.
    """
    if np.ndim(marks) != 2:
        raise ValueError("embed_corpus takes (B, n) marks, one per image")
    h, w = rgb.shape[1], rgb.shape[2]
    blk = _place_corpus(rgb, mesh)
    marks = place(marks, mesh, {0: DATA_AXIS})
    hl = blk.shape[1]
    coef = _corpus_forward(blk, h, w, mesh, config.precision)
    n = marks.shape[-1]
    idx = distributed_top_indices(coef, n, config.ordering, h, w, mesh)
    original = _gather_replicated(coef, idx, w, mesh)
    delta = modulation.embed_marks(
        original, marks, config.insertion.method, config.insertion.alpha,
        custom_insert=config.custom_insert, indices=idx) - original

    # Local sparse delta-IDCT: this rank owns rows [row0, row0 + Hl) of
    # every image; dY there is one (Hl, n) @ (n, W) product from the
    # (idx, delta) every spatial rank holds: no second all-to-all.
    row0 = mesh.index(SPATIAL_AXIS) * hl
    dh_loc = _inverse_rows(h, hl * mesh.shape[SPATIAL_AXIS],
                           blk.device)[row0:row0 + hl]
    dw = dct.basis_tensor(w, blk.device, torch.float32, inverse=True)
    rows = torch.div(idx, w, rounding_mode="floor")
    a = dh_loc.t()[rows] * delta[..., None]          # (Bl, n, Hl)
    b = dw.t()[idx % w]                              # (Bl, n, W)
    dy = dct.matmul(a.transpose(-1, -2), b, config.precision) * \
        inverse_scale(h, w)                          # (Bl, Hl, W)
    # clip(rgb/255 + dY) -> u8, rounded once: kernel K7's u8 mode.
    return add_quantize(blk.contiguous(), dy.contiguous(), True)


def extract_corpus(base, derived, n: int, mesh: Mesh,
                   config: ReadConfig = ReadConfig(), *, height=None):
    """Joint DP x TP extract over a corpus: this rank's (B/d, n) block of
    the marks, one per image.

    ``base``/``derived``: (B, H, W, 3), or the (B, Hp, W, 3) padded output
    of :func:`embed_corpus` (then pass the true ``height``); either may be
    this rank's block as ``mesh.Local``.
    """
    if height is None and isinstance(base, Local):
        raise ValueError("extract_corpus needs height= with a Local base")
    h = height if height is not None else base.shape[1]
    base = _place_corpus(base, mesh)
    derived = _place_corpus(derived, mesh)
    if base.shape != derived.shape:
        raise ValueError(
            "Derived coefficient length not equal to base coefficient length.")
    w = base.shape[2]
    if n >= h * w:
        raise ValueError(
            "Desired extraction length exceeds available coefficients.")
    cb = _corpus_forward(base, h, w, mesh, config.precision)
    # The extraction equations take derived - base; the DCT is linear, so
    # the luma DIFFERENCE is transformed once (the exact integer luma
    # difference for u8 pairs, ops/colorspace.luma_diff).
    cd = _row_pass_to_columns(colorspace.luma_diff(base, derived), h, w,
                              mesh, config.precision)
    idx = distributed_top_indices(cb, n, config.ordering, h, w, mesh)
    bvals = _gather_replicated(cb, idx, w, mesh)
    dnum = _gather_replicated(cd, idx, w, mesh)
    if config.custom_extract is not None:
        return config.custom_extract(idx, bvals, bvals + dnum)
    return modulation.extract_values(config.extraction.method,
                                     config.extraction.alpha, bvals,
                                     bvals + dnum)
