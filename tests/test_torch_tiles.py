"""The host side of the Hopper mainloop (``csrc/wgmma_tile.cuh``) on the CPU.

The kernels K1 and K1f read their DCT bases as tile images built here
(``kernels/_tiles.py``), and write their transformed operand in the same
layout on the card; these tests pin that layout to the formula the CUDA
source uses (``ssw::wg::swizzled``), the scratch sizes the wrappers
allocate, and the f64 error measures that ``chip_smoke.py`` and the card's
tests print, on the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_torch.config import Precision
from spread_spectrum_watermarking_torch.kernels import _tiles
from spread_spectrum_watermarking_torch.kernels import fold_pass as k1f
from spread_spectrum_watermarking_torch.kernels import luma_pass as k1


def _swizzled(r, k):
    """``ssw::wg::swizzled``: where (r, k) lies in a tile, in elements."""
    return r * 64 + ((((k >> 3) ^ r) & 7) << 3) + (k & 7)


@pytest.mark.parametrize("rows,depth", [(37, 59), (128, 64), (200, 130),
                                        (1080, 540)])
def test_tile_image_is_the_swizzled_k_major_layout(rows, depth):
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (2, rows, depth)).astype(np.float32))
    t = _tiles.tile_image(x)
    rt, kt = _tiles.tile_counts(rows, depth)
    assert t.shape == (2, rt, kt, 128, 64) and t.dtype == torch.bfloat16
    assert t.is_contiguous()
    torch.testing.assert_close(_tiles.untile_image(t, rows, depth),
                               x.to(torch.bfloat16), rtol=0, atol=0)
    flat = t.reshape(2, rt, kt, 128 * 64)
    rng = np.random.default_rng(0)
    for r, k in zip(rng.integers(0, rows, 64), rng.integers(0, depth, 64)):
        at = _swizzled(int(r % 128), int(k % 64))
        assert flat[1, r // 128, k // 64, at] == x[1, r, k].to(torch.bfloat16)
    # Zeros past the edges.
    padded = _tiles.untile_image(t, rt * 128, kt * 64)
    assert not bool(padded[..., rows:, :].any())
    assert not bool(padded[..., depth:].any())


@pytest.mark.parametrize("h,w", [(1080, 1920), (1920, 1080), (37, 59)])
def test_scratch_sizes_cover_the_tile_images(h, w):
    # The C entry points refuse scratch smaller than these sizes.
    for p, parts in ((Precision.DEFAULT, 1), (Precision.HIGH, 2)):
        rt, kt = -(-max(h, w) // 128), -(-min(h, w) // 64)
        assert k1._work_elems(3, h, w, p) == 3 * parts * rt * kt * 8192
        for axis in (-2, -1):
            n, other = (h, w) if axis == -2 else (w, h)
            rt, kt = -(-other // 128), -(-(n // 2) // 64)
            assert k1f._work_elems(3, h, w, axis, p) == \
                3 * 2 * parts * rt * kt * 8192


@pytest.mark.parametrize("h,w", [(64, 96), (96, 64)])
def test_luma_pass_f64_error_of_the_plain_version(h, w):
    # The plain version's sums are f32 in another order: a few units of
    # 2^-24 sum |C y| past the bf16 rounding, within the kernels' 2K bound.
    rng = np.random.default_rng(h)
    rgb = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8))
    base = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3),
                                         dtype=np.uint8))
    k = min(h, w)
    cases = ((None, Precision.DEFAULT, k), (base, Precision.DEFAULT, k),
             (None, Precision.HIGH, 3 * k))
    for b, p, terms in cases:
        out = k1.luma_pass_reference(rgb, b, p)
        err = k1.f64_error(out, rgb, b, p)
        assert 0.0 <= err <= 2 * terms
        # A value two bf16 steps off is caught.
        bad = out.clone()
        bad[0, 0, 0] = (bad[0, 0, 0].float() * (1 + 2.0 ** -6)).to(
            torch.bfloat16)
        assert k1.f64_error(bad, rgb, b, p) > err


@pytest.mark.parametrize("precision", [Precision.DEFAULT, Precision.HIGH])
@pytest.mark.parametrize("axis", [-2, -1])
def test_fold_pass_f64_error_of_the_plain_version(precision, axis):
    x = torch.from_numpy(np.random.default_rng(7).random(
        (2, 64, 96), dtype=np.float32))
    out = k1f.fold_pass_reference(x, axis, precision=precision)
    k = x.shape[axis] // 2 * (3 if precision is Precision.HIGH else 1)
    err = k1f.f64_error(out, x, axis, precision)
    assert 0.0 <= err <= 2 * k
    bad = out.clone()
    bad[1, 3, 5] += 1e-3 * float(bad.abs().max())
    assert k1f.f64_error(bad, x, axis, precision) > 2 * k
