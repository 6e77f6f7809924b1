"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked ``cuda`` and skips without a card. This file
imports the port, torch and numpy only, so it also runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_cuda.py`` (the
suite's ``conftest.py`` imports JAX).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_torch.kernels import add_quantize as k7
from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
from spread_spectrum_watermarking_torch.kernels import fold_pass as k1f
from spread_spectrum_watermarking_torch.kernels import highest_read as k9
from spread_spectrum_watermarking_torch.kernels import luma_pass as k1
from spread_spectrum_watermarking_torch.kernels import luma_u8 as k8
from spread_spectrum_watermarking_torch.kernels import read_tail as k5
from spread_spectrum_watermarking_torch.kernels import topk_select as k3
from spread_spectrum_watermarking_torch.models import pipeline as tp
from spread_spectrum_watermarking_torch.ops import colorspace, dct, ranking

pytestmark = pytest.mark.cuda

# Ragged in both axes, both orientations, and one shape under a tile.
GEOMETRIES = [(444, 640), (640, 444), (37, 59)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _images(seed, h, w, device, b=2):
    """Random u8 images and a copy changed by at most 3 steps per channel,
    as a marked image differs from its base."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    near = np.clip(rgb.astype(int) + rng.integers(-3, 4, rgb.shape), 0, 255)
    return (torch.from_numpy(rgb).to(device),
            torch.from_numpy(near.astype(np.uint8)).to(device))


def _k1_bound(rgb, base, t, r, high=False):
    """One bf16 ulp, plus the gamma_K bound of an f32 sum of K terms taken
    in another order, 2 K 2^-24 sum_k |C y|: the sums cancel near zero. In
    high mode the sum has 3K terms (three products per k) and y is the f32
    luma the kernel splits."""
    if base is None:
        y = colorspace.luma_u8(rgb)
    else:
        y = colorspace.luma_diff(base, rgb)
    dtype = torch.float32 if high else torch.bfloat16
    y = y.to(dtype).float().abs()
    h, w = rgb.shape[1:3]
    k = min(h, w) * (3 if high else 1)
    c = dct.basis_tensor(min(h, w), rgb.device, dtype).float().abs()
    terms = dct.matmul_f32(c, y) if h <= w else dct.matmul_f32(y, c.t())
    big = torch.maximum(t.abs(), r.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return ulp + 2 * k * 2.0 ** -24 * terms


def _one_byte_in(x):
    """A contiguous copy of ``x`` that starts one byte into its storage, as
    a view of a user's buffer may: its 4-byte words are misaligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_luma_pass_kernel_matches_plain(cuda, h, w):
    # Single and pair mode, from aligned images and from images one byte
    # into their storage (the scalar loads).
    rgb, near = _images(0, h, w, cuda)
    for img, other in ((rgb, near), (_one_byte_in(rgb), _one_byte_in(near))):
        for base in (None, other):
            before = k1.LAUNCHES
            t = k1.luma_pass(img, base).float()
            torch.cuda.synchronize()
            assert k1.LAUNCHES == before + 1
            r = k1.luma_pass_reference(img, base).float()
            assert bool(((t - r).abs() <= _k1_bound(img, base, t, r)).all())


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_luma_pass_high_kernel_matches_plain(cuda, h, w):
    rgb, _ = _images(4, h, w, cuda)
    for img in (rgb, _one_byte_in(rgb)):
        before = (k1.LAUNCHES, k1.HIGH_LAUNCHES)
        t = k1.luma_pass(img, precision=tw.Precision.HIGH)
        torch.cuda.synchronize()
        assert (k1.LAUNCHES, k1.HIGH_LAUNCHES) == (before[0], before[1] + 1)
        assert t.dtype == torch.bfloat16 and t.shape == img.shape[:3]
        t = t.float()
        r = k1.luma_pass_reference(img, precision=tw.Precision.HIGH).float()
        assert bool(((t - r).abs() <= _k1_bound(img, None, t, r, True)).all())


def _updates(h, w, n, device, seed=0, b=2):
    """(delta, idx) as the embed path makes them: n distinct flat indices,
    the DC among them where n > 1, and updates of either sign, scaled with
    the image as coefficients are, so that even one moves pixels."""
    rng = np.random.default_rng(seed + n)
    idx = np.stack([rng.choice(h * w, n, replace=False) for _ in range(b)])
    if n > 1:
        idx[:, 0] = 0
    delta = (rng.standard_normal((b, n)) * (h * w / 200.0)).astype(np.float32)
    return torch.from_numpy(delta).to(device), torch.from_numpy(idx).to(device)


# K4's geometries: also a right edge inside a tile with 16-byte rows.
K4_GEOMETRIES = GEOMETRIES + [(129, 272)]


@pytest.mark.parametrize("n", [1, 63, 200, 1000])
@pytest.mark.parametrize("h,w", K4_GEOMETRIES)
def test_factor_tile_pass_bit_equal_to_plain(cuda, h, w, n):
    delta, idx = _updates(h, w, n, cuda)
    before = (k4.FACTOR_LAUNCHES, k4.LAUNCHES)
    got = k4.factor_tiles(delta, idx, h, w)
    torch.cuda.synchronize()
    assert (k4.FACTOR_LAUNCHES, k4.LAUNCHES) == (before[0] + 1, before[1])
    for t, r in zip(got, k4.factor_tiles_reference(delta, idx, h, w)):
        assert t.shape == r.shape and torch.equal(t, r)


@pytest.mark.parametrize("n", [1, 64, 200, 1000])
@pytest.mark.parametrize("h,w", K4_GEOMETRIES)
def test_embed_epilogue_kernel_matches_plain(cuda, h, w, n):
    # Within one u8 step (dY's f32 sums in another order), and at n = 1
    # (one exact product a pixel) bit for bit; from an aligned image
    # (16-byte vectors where W % 16 == 0) and from one a byte into its
    # storage (the byte path).
    rgb, _ = _images(1, h, w, cuda)
    delta, idx = _updates(h, w, n, cuda, seed=1)
    r = k4.embed_epilogue_reference(rgb, delta, idx).int()
    assert bool((r != rgb.int()).any())  # the update reaches the pixels
    for img in (rgb, _one_byte_in(rgb)):
        before = k4.LAUNCHES
        t = k4.embed_epilogue(img, delta, idx)
        torch.cuda.synchronize()
        assert k4.LAUNCHES == before + 1
        assert t.dtype == torch.uint8 and t.shape == rgb.shape
        assert int((t.int() - r).abs().max()) <= 1
        # Only rounding ties of dY's sums differ, never a whole share.
        assert float((t.int() != r).float().mean()) <= 0.01
        if n == 1:
            assert torch.equal(t.int(), r)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rgb, near = _images(2, 37, 59, cuda)
    delta, idx = _updates(37, 59, 4, cuda)
    with pytest.raises(ValueError):
        k1.luma_pass(rgb.transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        k1.luma_pass(rgb, near[:1])  # base of another shape
    with pytest.raises(ValueError):
        k4.embed_epilogue(rgb, delta, idx.int())  # int32 indices
    with pytest.raises(ValueError):
        k4.embed_epilogue(rgb.float(), delta, idx)  # f32 image
    with pytest.raises(ValueError):
        k4.embed_epilogue(rgb, delta.cpu(), idx.cpu())  # CPU/CUDA mix
    with pytest.raises(ValueError):
        k4.embed_epilogue(rgb.transpose(1, 2), delta, idx)  # not contiguous


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_dct2d_kernels_match_plain(cuda, h, w):
    # Within k6_bound (the f32 sums in another order and the TF32 split),
    # from an aligned start and from a view one float in (4-byte copies).
    gen = torch.Generator(device=cuda).manual_seed(h * w)
    buf = torch.randn((2 * h * w + 1,), generator=gen, device=cuda)
    cases = [(k6.dct2_2d_fused, lambda v: k6.dct2_2d_fused_reference(v),
              False, False),
             (lambda v: k6.dct2_2d_fused(v, ortho=True),
              lambda v: k6.dct2_2d_fused_reference(v, True), False, True),
             (k6.idct2_2d_fused, k6.idct2_2d_fused_reference, True, False)]
    for x in (buf[:-1].view(2, h, w), buf[1:].view(2, h, w)):
        for kernel, plain, inverse, ortho in cases:
            before = (k6.FORWARD_LAUNCHES, k6.INVERSE_LAUNCHES)
            t = kernel(x)
            torch.cuda.synchronize()
            after = (before[0] + (not inverse), before[1] + inverse)
            assert (k6.FORWARD_LAUNCHES, k6.INVERSE_LAUNCHES) == after
            r = plain(x)
            assert bool(((t - r).abs() <= k6.k6_bound(x, inverse, ortho)).all())


def test_highest_path_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    marks = rng.standard_normal((2, 1, 200)).astype(np.float32)
    before = k6.FORWARD_LAUNCHES
    g_marked, g_ext = tw.embed_verified(torch.from_numpy(rgb).to(cuda),
                                        torch.from_numpy(marks).to(cuda))
    assert k6.FORWARD_LAUNCHES > before
    c_marked, c_ext = tw.embed_verified(torch.from_numpy(rgb),
                                        torch.from_numpy(marks))
    step = (g_marked.cpu().int() - c_marked.int()).abs().max()
    assert int(step) <= 1
    own = [torch.diagonal(tw.similarity(e.cpu(), torch.from_numpy(marks[:, 0])))
           for e in (g_ext, c_ext)]
    assert bool(((own[0] - own[1]).abs() <= 0.01).all())
    assert bool((own[0] > 6.0).all())
    before = k6.INVERSE_LAUNCHES
    full = tw.embed(torch.from_numpy(rgb).to(cuda),
                    torch.from_numpy(marks).to(cuda), sparse_idct=False)
    assert k6.INVERSE_LAUNCHES == before + 1
    assert int((full.cpu().int() - g_marked.cpu().int()).abs().max()) <= 1


def test_high_path_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    marks = rng.standard_normal((2, 1, 200)).astype(np.float32)
    cfg = tw.WriteConfig(precision=tw.Precision.HIGH)
    before = (k1.LAUNCHES, k1.HIGH_LAUNCHES, k4.LAUNCHES, k5.LAUNCHES)
    g_marked, g_ext = tw.embed_verified(torch.from_numpy(rgb).to(cuda),
                                        torch.from_numpy(marks).to(cuda), cfg)
    torch.cuda.synchronize()
    # K1's high mode (base), K4 (epilogue), K5 (read tail); K1's single
    # and pair modes not.
    assert (k1.LAUNCHES, k1.HIGH_LAUNCHES, k4.LAUNCHES, k5.LAUNCHES) == \
        (before[0], before[1] + 1, before[2] + 1, before[3] + 1)
    c_marked, c_ext = tw.embed_verified(torch.from_numpy(rgb),
                                        torch.from_numpy(marks), cfg)
    assert int((g_marked.cpu().int() - c_marked.int()).abs().max()) <= 1
    own = [torch.diagonal(tw.similarity(e.cpu(), torch.from_numpy(marks[:, 0])))
           for e in (g_ext, c_ext)]
    assert bool(((own[0] - own[1]).abs() <= 0.1).all())
    assert bool((own[0] > 6.0).all())


def test_dct2d_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 37, 59), device=cuda)
    with pytest.raises(ValueError):
        k6.dct2_2d_fused(x.double())
    with pytest.raises(ValueError):
        k6.dct2_2d_fused(x.transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        k6.idct2_2d_fused(x[:0])  # empty


@pytest.mark.parametrize("precision", [tw.Precision.DEFAULT,
                                       tw.Precision.HIGH])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("h,w", [(64, 128), (128, 64), (96, 160),
                                 (100, 132), (66, 98)])
def test_fold_pass_kernel_matches_plain(cuda, precision, axis, h, w):
    # Products of bf16 values are exact, so only the order of the f32 sums
    # differs: 2 K u sum |c| |v|, K = N/2 terms (3N/2 at HIGH). Once from an
    # aligned start and once from a view one float in (the scalar loads).
    gen = torch.Generator(device=cuda).manual_seed(h * w + axis)
    buf = torch.randn((2 * h * w + 1,), generator=gen, device=cuda)
    high = precision is tw.Precision.HIGH
    for x in (buf[:-1].view(2, h, w), buf[1:].view(2, h, w)):
        before = (k1f.LAUNCHES, k1f.HIGH_LAUNCHES)
        t = k1f.fold_pass(x, axis, precision=precision)
        torch.cuda.synchronize()
        assert (k1f.LAUNCHES, k1f.HIGH_LAUNCHES) == \
            (before[0] + (not high), before[1] + high)
        assert t.dtype == torch.float32 and t.shape == x.shape
        r = k1f.fold_pass_reference(x, axis, precision=precision)
        k = x.shape[axis] // 2 * (3 if high else 1)
        bound = 2 * k * 2.0 ** -24 * k1f.fold_terms(x, axis, precision)
        assert bool(((t - r).abs() <= bound).all())


def test_folded_transforms_launch_k1f_at_the_fast_tiers(cuda):
    x = torch.rand((2, 64, 96), device=cuda)
    for p, launches in ((tw.Precision.DEFAULT, (2, 0)),
                        (tw.Precision.HIGH, (0, 2)),
                        (tw.Precision.HIGHEST, (0, 0))):
        before = (k1f.LAUNCHES, k1f.HIGH_LAUNCHES)
        c = dct.dct2_2d(x, precision=p, fold=True)
        back = dct.idct2_2d(c, precision=p, fold=True)  # plain products
        torch.cuda.synchronize()
        assert (k1f.LAUNCHES - before[0], k1f.HIGH_LAUNCHES - before[1]) \
            == launches
        tol = 0.1 if p is tw.Precision.DEFAULT else 1e-4
        assert float((back - x).abs().max()) <= tol


@pytest.mark.parametrize("npix", [4 * 37 * 59, 37 * 59, 1])
def test_add_quantize_kernel_bit_equal_to_plain(cuda, npix):
    # Both correctly rounded: bit for bit, in both modes, with whole groups
    # of four pixels (u8) or 16-byte vectors (f32), a tail, and misaligned
    # starts: the image three bytes or one byte in (the scalar paths), dY
    # one float in (the scalar path in u8 mode, vectors in f32 mode).
    gen = torch.Generator(device=cuda).manual_seed(npix)
    rgb = torch.randint(0, 256, (npix + 1, 3), generator=gen, device=cuda,
                        dtype=torch.uint8)
    dy = torch.randn((npix + 1,), generator=gen, device=cuda) * 0.02
    views = ((rgb[:npix], dy[:npix]), (rgb[1:], dy[1:]),
             (rgb[:npix], dy[1:]), (_one_byte_in(rgb[:npix]), dy[:npix]))
    for r, d in views:
        for quantize in (False, True):
            before = k7.LAUNCHES
            t = k7.add_quantize(r, d, quantize)
            torch.cuda.synchronize()
            assert k7.LAUNCHES == before + 1
            want = k7.add_quantize_reference(r, d, quantize)
            assert t.dtype == want.dtype and torch.equal(
                t.view(torch.uint8), want.view(torch.uint8))


def test_highest_embed_launches_add_quantize_once(cuda):
    rng = np.random.default_rng(7)
    rgb = torch.from_numpy(rng.integers(0, 256, (2, 64, 96, 3),
                                        dtype=np.uint8)).to(cuda)
    marks = torch.from_numpy(rng.standard_normal((2, 1, 100)).astype(
        np.float32)).to(cuda)
    before = k7.LAUNCHES
    marked, _ = tw.embed_verified(rgb, marks)
    torch.cuda.synchronize()
    assert k7.LAUNCHES == before + 1 and marked.dtype == torch.uint8
    out = tw.embed(rgb, marks, quantize=False)  # K7's f32 mode
    assert k7.LAUNCHES == before + 2 and out.dtype == torch.float32
    assert torch.equal(colorspace.f32_to_u8(out), marked)


def test_fold_and_add_quantize_wrappers_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((2, 64, 96), device=cuda)
    with pytest.raises(ValueError):
        k1f.fold_pass(x.transpose(1, 2), -2)  # not contiguous
    with pytest.raises(ValueError):
        k1f.fold_pass(x.double(), -1)  # not f32
    with pytest.raises(ValueError):
        k1f.fold_pass(x[:, :63], -2)  # odd length
    rgb = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=cuda)
    dy = torch.zeros((2, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        k7.add_quantize(rgb.transpose(1, 2), dy, True)  # not contiguous
    with pytest.raises(ValueError):
        k7.add_quantize(rgb, dy.double(), True)  # dY not f32
    with pytest.raises(ValueError):
        k7.add_quantize(rgb.float(), dy, False)  # image not u8
    with pytest.raises(ValueError):
        k7.add_quantize(rgb, dy.cpu(), True)  # CPU/CUDA mix


def _crop(x):
    """A strided view: ``x`` inside a border of 8, as a user's crop is."""
    big = torch.zeros((x.shape[0], x.shape[1] + 16, x.shape[2] + 16,
                       *x.shape[3:]), dtype=x.dtype, device=x.device)
    big[:, 8:-8, 8:-8] = x
    return big[:, 8:-8, 8:-8]


@pytest.mark.parametrize("precision", [tw.Precision.DEFAULT,
                                       tw.Precision.HIGH])
def test_fast_tiers_take_strided_views(cuda, precision):
    # _half_pass (K1), _embed_fast (K4) and _extract_fast_tail (K1's pair
    # mode) on cropped u8 views: the same bits as on contiguous copies,
    # and the CPU run's within one u8 step and 0.1 sigma.
    rng = np.random.default_rng(11)
    rgb = torch.from_numpy(rng.integers(0, 256, (2, 96, 128, 3),
                                        dtype=np.uint8)).to(cuda)
    marks = torch.from_numpy(rng.standard_normal((2, 1, 200)).astype(
        np.float32)).to(cuda)
    cfg = tw.WriteConfig(precision=precision)
    rcfg = tw.ReadConfig(precision=precision)
    view = _crop(rgb)
    assert not view.is_contiguous()
    marked, ext = tw.embed_verified(view, marks, cfg)
    d_marked, d_ext = tw.embed_verified(rgb, marks, cfg)
    assert torch.equal(marked, d_marked) and torch.equal(ext, d_ext)
    assert torch.equal(tw.embed(view, marks, cfg), d_marked)
    idx, vals = tw.rank_base(view, 200, rcfg)
    read = tw.extract_ranked(view, _crop(marked), idx, vals, rcfg)
    assert torch.equal(read, d_ext)
    c_marked, c_ext = tw.embed_verified(rgb.cpu(), marks.cpu(), cfg)
    assert int((marked.cpu().int() - c_marked.int()).abs().max()) <= 1
    own = [torch.diagonal(tw.similarity(e.cpu(), marks[:, 0].cpu()))
           for e in (read, c_ext)]
    assert bool(((own[0] - own[1]).abs() <= 0.1).all())


def test_dct_ops_take_strided_planes(cuda):
    # K6a/K6b (HIGHEST) and K1f (fold=True, DEFAULT and HIGH) on a
    # transposed plane and a crop: the same bits as on contiguous copies;
    # the HIGHEST transforms within k6_bound of the CPU's.
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand((2, 96, 128), generator=gen, device=cuda)
    for view in (x.transpose(-1, -2), _crop(x)):
        assert not view.is_contiguous()
        dense = view.contiguous()
        before = (k6.FORWARD_LAUNCHES, k6.INVERSE_LAUNCHES, k1f.LAUNCHES,
                  k1f.HIGH_LAUNCHES)
        assert torch.equal(dct.dct2_2d(view), dct.dct2_2d(dense))
        assert torch.equal(dct.idct2_2d(view), dct.idct2_2d(dense))
        for p in (tw.Precision.DEFAULT, tw.Precision.HIGH):
            assert torch.equal(dct.dct2_2d(view, precision=p, fold=True),
                               dct.dct2_2d(dense, precision=p, fold=True))
        assert (k6.FORWARD_LAUNCHES, k6.INVERSE_LAUNCHES, k1f.LAUNCHES,
                k1f.HIGH_LAUNCHES) == tuple(
                    n + d for n, d in zip(before, (2, 2, 4, 4)))
        cpu = dense.cpu()
        t = dct.dct2_2d(view).cpu()
        assert bool(((t - dct.dct2_2d(cpu)).abs()
                     <= k6.k6_bound(cpu)).all())
        t = dct.idct2_2d(view).cpu()
        assert bool(((t - dct.idct2_2d(cpu)).abs()
                     <= k6.k6_bound(cpu, True)).all())


def test_tf32_does_not_leak_into_highest_products(cuda):
    # coeffs_at, the sparse delta and HIGHEST similarity run their f32
    # products with TF32 off (ops.dct._f32_sums), whatever the caller set.
    gen = torch.Generator(device=cuda).manual_seed(4)
    y = torch.rand((2, 96, 128), generator=gen, device=cuda)
    idx = torch.randint(0, 96 * 128, (2, 300), generator=gen, device=cuda)
    delta = torch.randn((2, 300), generator=gen, device=cuda)
    ext = torch.randn((2, 300), generator=gen, device=cuda)
    cand = torch.randn((5, 300), generator=gen, device=cuda)

    def products():
        return (dct.dct2_coeffs_at(y, idx),
                tp._sparse_idct_delta(delta, idx, 96, 128,
                                      tw.Precision.HIGHEST),
                tw.similarity(ext, cand))

    m = torch.backends.cuda.matmul
    before = (torch.get_float32_matmul_precision(), m.allow_tf32)
    want = products()
    try:
        torch.set_float32_matmul_precision("high")
        m.allow_tf32 = True
        got = products()
        assert m.allow_tf32  # the caller's setting is back after each call
    finally:
        torch.set_float32_matmul_precision(before[0])
        m.allow_tf32 = before[1]
    assert (torch.get_float32_matmul_precision(), m.allow_tf32) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h,w", [(64, 128), (128, 64), (129, 200),
                                 (200, 129)])
def test_luma_pass_kernel_at_tile_edges(cuda, h, w):
    # Exactly one 128-row tile, one 64-deep stage, and one past each, in
    # both orientations, every mode, from a view one byte in.
    rgb, near = _images(6, h, w, cuda)
    for img, other in ((rgb, near), (_one_byte_in(rgb), _one_byte_in(near))):
        for base, p in ((None, tw.Precision.DEFAULT),
                        (other, tw.Precision.DEFAULT),
                        (None, tw.Precision.HIGH)):
            t = k1.luma_pass(img, base, p).float()
            r = k1.luma_pass_reference(img, base, p).float()
            bound = _k1_bound(img, base, t, r, p is tw.Precision.HIGH)
            assert bool(((t - r).abs() <= bound).all())


# The pre-PR kernels' errors against f64 (wmma, the tensor cores summing
# the whole k range), in units of 2^-24 sum |a| |b| (past the bf16 rounding
# for K1), on 4 x 1080 x 1920 random inputs: scripts/k1_ab.py on an
# NVIDIA H100 80GB HBM3 at 700 W. The kernels on the shared wgmma
# mainloop sum each 64-deep stage apart and add the sums in f32.
PRE_WGMMA_F64_ERR = {"single": 13.82, "pair": 3.19, "high": 42.44,
                     ("default", -2): 7.51, ("default", -1): 13.58,
                     ("high", -2): 25.81, ("high", -1): 43.85}


def test_luma_pass_f64_error_no_worse_than_before(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    rgb = torch.randint(0, 256, (4, 1080, 1920, 3), generator=gen,
                        device=cuda, dtype=torch.uint8)
    base = torch.randint(0, 256, rgb.shape, generator=gen, device=cuda,
                         dtype=torch.uint8)
    for name, b, p in (("single", None, tw.Precision.DEFAULT),
                       ("pair", base, tw.Precision.DEFAULT),
                       ("high", None, tw.Precision.HIGH)):
        err = k1.f64_error(k1.luma_pass(rgb, b, p), rgb, b, p)
        assert err <= PRE_WGMMA_F64_ERR[name], (name, err)


def test_fold_pass_f64_error_no_worse_than_before(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.rand((4, 1080, 1920), generator=gen, device=cuda)
    for p in (tw.Precision.DEFAULT, tw.Precision.HIGH):
        for axis in (-2, -1):
            err = k1f.f64_error(k1f.fold_pass(x, axis, precision=p), x, axis,
                                p)
            assert err <= PRE_WGMMA_F64_ERR[(p.value, axis)], (p, axis, err)


def _k3_keys(name, rng):
    """K3's mode (A) traps: (key int32, pos int64 or None, n), on the CPU."""
    i32 = np.iinfo(np.int32)
    if name == "full_range":
        key = rng.integers(i32.min, i32.max, (3, 50000), endpoint=True)
        return key.astype(np.int32), None, 300
    if name == "f32_total_order":
        x = rng.standard_normal((2, 100003)).astype(np.float32)
        x[:, ::7] = -0.0
        x[:, 1::7] = 0.0
        bits = x.view(np.int32)
        return np.where(bits < 0, bits ^ 0x7FFFFFFF, bits), None, 2500
    if name == "extremes":
        vals = np.array([i32.min, i32.min + 1, -1, 0, 1, i32.max - 1,
                         i32.max], np.int32)
        return vals[rng.integers(0, 7, (2, 30001))], None, 1000
    if name == "equal_row":
        return np.full((2, 100000), 7, np.int32), None, 2000
    if name == "equal_row_permuted_pos":
        pos = np.stack([rng.permutation(100000) for _ in range(2)])
        return np.full((2, 100000), -3, np.int32), pos * 1000 + 11, 1500
    if name == "n_is_one":
        return rng.integers(-5, 5, (4, 77777)).astype(np.int32), None, 1
    if name == "n_is_length":
        return rng.integers(-5, 5, (4, 2183)).astype(np.int32), None, 2183
    if name == "batch_dims":
        return rng.integers(-20, 20, (2, 3, 5001)).astype(np.int32), None, 100
    if name == "resort":  # (48, n) with the selected flat indices as pos
        pos = np.stack([rng.choice(2073600, 1000, replace=False)
                        for _ in range(48)])
        return rng.integers(0, 300, (48, 1000)).astype(np.int32), pos, 1000
    if name == "tiled_candidates":  # tile-ordered candidates, per row
        tiles = np.stack([rng.choice(64800, 1000, replace=False)
                          for _ in range(4)])
        pos = (tiles[..., None] * 32 + np.arange(32)).reshape(4, 32000)
        return rng.integers(0, 99, (4, 32000)).astype(np.int32), pos, 1000
    if name == "shared_pos":
        return (rng.integers(0, 9, (3, 40960)).astype(np.int32),
                rng.permutation(2 ** 31 - 1 - np.arange(40960)), 500)
    if name == "global_sort":  # n above the 16,384 the shared sort holds
        return rng.integers(-3000, 3000, (2, 300001)).astype(np.int32), \
            None, 20000
    raise KeyError(name)


K3_CASES = ["full_range", "f32_total_order", "extremes", "equal_row",
            "equal_row_permuted_pos", "n_is_one", "n_is_length",
            "batch_dims", "resort", "tiled_candidates", "shared_pos",
            "global_sort"]


@pytest.mark.parametrize("name", K3_CASES)
def test_top_by_key_kernel_matches_plain(cuda, name):
    key, pos, n = _k3_keys(name, np.random.default_rng(K3_CASES.index(name)))
    key = torch.from_numpy(np.ascontiguousarray(key)).to(cuda)
    if pos is not None:
        pos = torch.from_numpy(np.ascontiguousarray(pos)).to(cuda)
    before = k3.LAUNCHES
    got = k3.top_by_key(key, pos, n)
    torch.cuda.synchronize()
    assert k3.LAUNCHES == before + 1
    # Up to CAP: the two-stage path, two device launches.
    assert n > k3.CAP or k3.LAST_DEVICE_LAUNCHES == 2
    assert torch.equal(got, k3.top_by_key_reference(key, pos, n))
    # Keys that start 4 bytes into their storage take the scalar loads.
    assert torch.equal(k3.top_by_key(_one_word_in(key), pos, n), got)


def _one_word_in(x):
    """A contiguous copy of ``x`` that starts one element into its
    storage: not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _tied_plane(seed, b, h, w, device):
    """A bf16 plane with a 1/f-like falloff, many ties, both signed zeros
    and a large DC."""
    rng = np.random.default_rng(seed)
    f = np.sqrt(np.arange(h)[:, None] ** 2 + np.arange(w)[None, :] ** 2) + 1
    x = rng.standard_normal((b, h, w)) * 40 / f
    x = np.round(x * 64) / 64
    m = rng.random((b, h, w))
    x[m < 0.1] = 0.0
    x[(m >= 0.1) & (m < 0.2)] = -0.0
    x[:, 0, 0] = 1e4
    return torch.from_numpy(x.astype(np.float32)).to(device).to(
        torch.bfloat16)


@pytest.mark.parametrize("ordering", list(tw.Ordering))
@pytest.mark.parametrize("b,h,w,n", [(2, 37, 59, 1), (2, 37, 59, 37 * 59),
                                     (2, 444, 640, 1000),
                                     (3, 640, 444, 20000),
                                     (4, 1080, 1920, 1000), (2, 37, 61, 9)])
def test_top_of_plane_kernel_matches_plain(cuda, ordering, b, h, w, n):
    plane = _tied_plane(h + n, b, h, w, cuda)
    before = k3.PLANE_LAUNCHES
    idx, est = k3.top_of_plane(plane, n, ordering)
    torch.cuda.synchronize()
    assert k3.PLANE_LAUNCHES == before + 1
    assert n > k3.CAP or k3.LAST_DEVICE_LAUNCHES == 2
    want_idx, want_est = k3.top_of_plane_reference(plane, n, ordering)
    assert torch.equal(idx, want_idx)
    assert torch.equal(est.view(torch.int32), want_est.view(torch.int32))
    # A plane that starts 2 bytes into its storage takes the plain loads.
    got = k3.top_of_plane(_one_word_in(plane), n, ordering)
    assert torch.equal(got[0], idx) and torch.equal(got[1], est)


@pytest.mark.parametrize("ordering", [tw.Ordering.ENERGY,
                                      tw.Ordering.ENERGY_ORTHOGONAL])
@pytest.mark.parametrize("b,h,w,n", [(2, 37, 59, 1), (2, 37, 59, 37 * 59),
                                     (2, 444, 640, 1000),
                                     (3, 640, 444, 20000),
                                     (4, 1080, 1920, 1000), (2, 37, 61, 9)])
def test_top_of_coeffs_kernel_matches_plain(cuda, ordering, b, h, w, n):
    coeffs = _tied_plane(h + n, b, h, w, cuda).float()
    coeffs[:, 1, 1] = float("nan")
    before = k3.COEFF_LAUNCHES
    got = k3.top_of_coeffs(coeffs, n, ordering)
    torch.cuda.synchronize()
    assert k3.COEFF_LAUNCHES == before + 1
    assert n > k3.CAP or k3.LAST_DEVICE_LAUNCHES == 2
    assert torch.equal(got, k3.top_of_coeffs_reference(coeffs, n, ordering))
    assert torch.equal(k3.top_of_coeffs(_one_word_in(coeffs), n, ordering),
                       got)


@pytest.mark.parametrize("ordering", list(tw.Ordering))
@pytest.mark.parametrize("h,w,n", [(37, 59, 50), (64, 96, 20),
                                   (200, 180, 30), (1080, 1920, 1000)])
def test_top_indices_on_the_card_is_the_cpu_route(cuda, ordering, h, w, n):
    # ENERGY and ENERGY_ORTHOGONAL take one select over the plane on the
    # card, LEGACY the tiled route; the CPU takes JAX's routes.
    rng = np.random.default_rng(h + w)
    x = np.round(rng.standard_normal((2, h, w)) * 4) / 4
    x[rng.random((2, h, w)) < 0.2] = -0.0
    plane = torch.from_numpy(x.astype(np.float32))
    before = k3.LAUNCHES + k3.COEFF_LAUNCHES
    got = ranking.top_indices(plane.to(cuda), n, ordering)
    torch.cuda.synchronize()
    assert k3.LAUNCHES + k3.COEFF_LAUNCHES > before
    assert torch.equal(got.cpu(), ranking.top_indices(plane, n, ordering))
    # exact_only keeps the key plane's select: the same function.
    assert torch.equal(
        ranking.top_indices(plane.to(cuda), n, ordering, exact_only=True),
        got)


def test_topk_select_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    key = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        k3.top_by_key(key.long(), None, 4)  # not int32
    with pytest.raises(ValueError):
        k3.top_by_key(key.t(), None, 1)  # not contiguous
    with pytest.raises(ValueError):
        k3.top_by_key(key, None, 65)  # n > L
    with pytest.raises(ValueError):
        k3.top_by_key(key, torch.arange(63, device=cuda), 4)  # pos shape
    with pytest.raises(ValueError):
        k3.top_by_key(key, torch.arange(64, device=cuda).int(), 4)
    with pytest.raises(ValueError):
        k3.top_by_key(key, torch.arange(64), 4)  # CPU/CUDA mix
    plane = torch.zeros((2, 8, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        k3.top_of_plane(plane.float(), 4, tw.Ordering.ENERGY)  # not bf16
    with pytest.raises(ValueError):
        k3.top_of_plane(plane.transpose(1, 2), 4, tw.Ordering.ENERGY)
    with pytest.raises(ValueError):
        k3.top_of_coeffs(plane, 4, tw.Ordering.ENERGY)  # not f32
    with pytest.raises(ValueError):
        k3.top_of_coeffs(plane.float(), 4, tw.Ordering.LEGACY)


@pytest.mark.parametrize("precision", list(tw.Precision))
def test_every_tier_selects_through_k3(cuda, precision):
    rng = np.random.default_rng(21)
    rgb = torch.from_numpy(rng.integers(0, 256, (2, 64, 96, 3),
                                        dtype=np.uint8)).to(cuda)
    marks = torch.from_numpy(rng.standard_normal((2, 1, 100)).astype(
        np.float32)).to(cuda)
    fast = precision is not tw.Precision.HIGHEST
    for version in (1, 2) if fast else (2,):
        cfg = tw.WriteConfig(precision=precision, rank_version=version)
        planes, keys, coeffs = (k3.PLANE_LAUNCHES, k3.LAUNCHES,
                                k3.COEFF_LAUNCHES)
        marked, ext = tw.embed_verified(rgb, marks, cfg)
        torch.cuda.synchronize()
        # Generation 2: one call over the plane, its re-sort inside;
        # generation 1: the select over its keys and the re-sort; HIGHEST:
        # the f32 mode.
        assert k3.PLANE_LAUNCHES - planes == (fast and version == 2)
        assert k3.LAUNCHES - keys == (2 if fast and version == 1 else 0)
        assert k3.COEFF_LAUNCHES - coeffs == (not fast)
        c_marked, c_ext = tw.embed_verified(rgb.cpu(), marks.cpu(), cfg)
        assert int((marked.cpu().int() - c_marked.int()).abs().max()) <= 1


def _ranked(h, w, n, device, seed=0, b=2):
    """(b, n) int64 flat indices drawn with repeats (n may exceed H W),
    the DC and the last coefficient among them."""
    rng = np.random.default_rng(seed + n)
    idx = rng.integers(0, h * w, (b, n))
    idx[:, 0] = 0
    idx[:, -1] = h * w - 1
    return torch.from_numpy(idx.astype(np.int64)).to(device)


@pytest.mark.parametrize("n", [1, 1000, 20000])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_read_tail_kernel_matches_plain(cuda, h, w, n):
    # Within k5_bound (the first pass's bf16 rounding from sums in another
    # order, the dots in another order) and no further from the f64 read
    # than read_tail.gates allows, from aligned images and from views one
    # byte into their storage.
    rgb, near = _images(5, h, w, cuda)
    idx = _ranked(h, w, n, cuda)
    for derived, base in ((near, rgb), (_one_byte_in(near), _one_byte_in(rgb))):
        before = (k5.LAUNCHES, k1.LAUNCHES)
        t = k5.read_tail(derived, base, idx)
        torch.cuda.synchronize()
        assert (k5.LAUNCHES, k1.LAUNCHES) == (before[0] + 1, before[1])
        assert t.dtype == torch.float32 and t.shape == (2, n)
        g = k5.gates(t, near, rgb, idx)
        assert g["within_bound"] and g["within_f64"], g


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_read_tail_repeats_and_ignores_the_batch(cuda, h, w):
    # Bit for bit: a second call; each image alone, in other splits of the
    # batch, and with one shared index set; so a Reader's chunk of any size
    # reads what the Writer's verify read.
    rgb, near = _images(7, h, w, cuda, b=4)
    idx = _ranked(h, w, 500, cuda, b=4)
    whole = k5.read_tail(near, rgb, idx)
    assert torch.equal(whole, k5.read_tail(near, rgb, idx))
    for lo, hi in ((0, 1), (1, 4), (2, 3)):
        part = k5.read_tail(near[lo:hi].contiguous(), rgb[lo:hi].contiguous(),
                            idx[lo:hi].contiguous())
        assert torch.equal(part, whole[lo:hi])
    shared = k5.read_tail(near, rgb, idx[2])
    assert torch.equal(shared[2], whole[2])
    assert torch.equal(k5.read_tail(near, rgb, idx[2].expand(4, -1)), shared)


@pytest.mark.parametrize("h,w", [(2400, 2432), (2432, 2400), (8192, 8208)])
def test_read_tail_kernel_matches_plain_at_large_sides(cuda, h, w):
    # Shorter sides from 2,400 to 8,192 in both orientations, through both
    # gates: the 16-byte loads (every row 16-byte aligned) and the byte
    # loads (a view one byte into its storage), 1000 indices with repeats.
    rgb, near = _images(9, h, w, cuda, b=1)
    idx = _ranked(h, w, 1000, cuda, b=1)
    for derived, base in ((near, rgb), (_one_byte_in(near),
                                        _one_byte_in(rgb))):
        t = k5.read_tail(derived, base, idx)
        torch.cuda.synchronize()
        g = k5.gates(t, near, rgb, idx)
        assert g["within_bound"] and g["within_f64"] and g["finite"], g
        del t


@pytest.mark.parametrize("h,w", [(1080, 1920), (640, 444)])
def test_read_tail_mixed_row_counts_match_each_image_alone(cuda, h, w):
    # One batch: an image whose 1000 indices share one row, one whose
    # indices cover min(n, S) rows (whole m tiles), one of random indices;
    # the product walks a different number of m tiles for each, and each
    # image reads, bit for bit, what it reads alone.
    n = 1000
    rgb, near = _images(10, h, w, cuda, b=3)
    idx = _ranked(h, w, n, cuda, b=3)
    s, l = min(h, w), max(h, w)
    a = torch.arange(n, device=cuda) % s
    c = torch.arange(n, device=cuda) % l
    land = h <= w
    idx[0] = 5 * w + c if land else c * w + 5
    idx[1] = a * w + c if land else c * w + a
    whole = k5.read_tail(near, rgb, idx)
    g = k5.gates(whole, near, rgb, idx)
    assert g["within_bound"] and g["within_f64"] and g["finite"], g
    for i in range(3):
        alone = k5.read_tail(near[i:i + 1].contiguous(),
                             rgb[i:i + 1].contiguous(),
                             idx[i:i + 1].contiguous())
        assert torch.equal(alone[0], whole[i])
    count, _, _ = k5.compact_rows_reference(idx.cpu(), h, w, 3)
    assert count.tolist()[:2] == [1, min(n, s)]


_OUT_OF_RANGE = textwrap.dedent("""
    import torch
    from spread_spectrum_watermarking_torch.kernels import read_tail as k5
    img = torch.zeros((2, 37, 59, 3), dtype=torch.uint8, device="cuda")
    idx = torch.zeros((2, 64), dtype=torch.int64, device="cuda")
    idx[{image}, 5] = {value}
    k5.read_tail(img, img, idx)
    torch.cuda.synchronize()
""")


def test_read_tail_raises_at_an_index_out_of_range(cuda):
    # The kernel's device-side assert fails, as PyTorch's indexing kernels
    # do; it leaves the process's CUDA context unusable, so each bad call
    # runs in a process of its own.
    root = Path(__file__).resolve().parent.parent
    for image, value in ((0, -1), (1, 37 * 59)):
        proc = subprocess.run(
            [sys.executable, "-c",
             _OUT_OF_RANGE.format(image=image, value=value)],
            cwd=root, capture_output=True, text=True, timeout=600)
        assert proc.returncode != 0
        assert "device-side assert" in proc.stderr, proc.stderr[-2000:]
    rgb, near = _images(8, 37, 59, cuda)
    idx = _ranked(37, 59, 64, cuda)
    assert bool(k5.read_tail(near, rgb, idx).isfinite().all())
    with pytest.raises(ValueError):
        k5.read_tail(near, rgb, idx.int())  # int32 indices
    with pytest.raises(ValueError):
        k5.read_tail(near.transpose(1, 2), rgb.transpose(1, 2), idx)
    with pytest.raises(ValueError):
        k5.read_tail(near, rgb, idx.cpu())  # CPU/CUDA mix


@pytest.mark.parametrize("precision", [tw.Precision.DEFAULT,
                                       tw.Precision.HIGH])
def test_fast_reads_go_through_k5(cuda, precision):
    # embed_verified and the detect path (rank_base + extract_ranked) read
    # through K5 once each, bit-equal, and never K1's pair mode;
    # extract(sparse_derived=False) keeps K1's pair mode and its full second
    # pass, within 0.1 sigma of K5's read.
    rng = np.random.default_rng(31)
    rgb = torch.from_numpy(rng.integers(0, 256, (2, 96, 128, 3),
                                        dtype=np.uint8)).to(cuda)
    marks = torch.from_numpy(rng.standard_normal((2, 1, 200)).astype(
        np.float32)).to(cuda)
    cfg, rcfg = (tw.WriteConfig(precision=precision),
                 tw.ReadConfig(precision=precision))
    before = (k5.LAUNCHES, k1.PAIR_LAUNCHES)
    marked, ext = tw.embed_verified(rgb, marks, cfg)
    idx, vals = tw.rank_base(rgb, 200, rcfg)
    sparse = tw.extract_ranked(rgb, marked, idx, vals, rcfg)
    torch.cuda.synchronize()
    assert (k5.LAUNCHES, k1.PAIR_LAUNCHES) == (before[0] + 2, before[1])
    assert torch.equal(sparse, ext)
    full = tw.extract(rgb, marked, 200, rcfg, sparse_derived=False)
    torch.cuda.synchronize()
    assert (k5.LAUNCHES, k1.PAIR_LAUNCHES) == (before[0] + 2, before[1] + 1)
    sims = [torch.diagonal(tw.similarity(e, marks[:, 0])) for e in (ext, full)]
    assert bool(((sims[0] - sims[1]).abs() <= 0.1).all())
    assert bool((sims[0] > 6.0).all())


def _luma_bits_equal(x):
    """K8 on ``x`` (one launch) against the table, bit for bit."""
    before = k8.LAUNCHES
    t = k8.luma_u8(x)
    torch.cuda.synchronize()
    assert k8.LAUNCHES == before + 1
    r = k8.luma_u8_reference(x)
    assert t.shape == x.shape[:-1] and t.dtype == torch.float32
    assert torch.equal(t.view(torch.int32), r.view(torch.int32))


def test_luma_u8_kernel_bit_equal_on_every_colour(cuda):
    # One 4096 x 4096 image holds every colour once (the 16-byte path), and
    # the same bytes one byte into their storage (the byte path).
    v = torch.arange(1 << 24, dtype=torch.int32, device=cuda)
    rgb = torch.stack([v >> 16, (v >> 8) & 255, v & 255], -1).to(
        torch.uint8).reshape(4096, 4096, 3)
    _luma_bits_equal(rgb)
    _luma_bits_equal(_one_byte_in(rgb))


@pytest.mark.parametrize("view", ["batch", "portrait", "odd_count",
                                  "strided", "one_byte_in", "single",
                                  "five_dims"])
def test_luma_u8_kernel_bit_equal_on_views(cuda, view):
    # A batch (16-pixel groups), portrait, a pixel count not a multiple of
    # 16 (the byte tail), strided and misaligned views (byte loads), one
    # image, and leading dimensions folded.
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(0, 256, (3, 64, 96, 3),
                                      dtype=np.uint8)).to(cuda)
    if view == "portrait":
        x = x.transpose(1, 2).contiguous()
    elif view == "odd_count":
        x = x[:, :37, :53].contiguous()
    elif view == "strided":
        x = x[:, 1::2, ::3]
    elif view == "one_byte_in":
        x = _one_byte_in(x)
    elif view == "single":
        x = x[1]
    elif view == "five_dims":
        x = x.reshape(3, 1, 64, 96, 3)
    _luma_bits_equal(x)


@pytest.mark.parametrize("n", [1, 1000, 20000])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_highest_read_kernel_matches_plain(cuda, h, w, n):
    # Within k9_bound (K6a's TF32 split of one pass, the first pass's and
    # the dots' f32 sums in another order) and no further from the f64
    # read than highest_read.gates allows.
    rgb, _ = _images(15, h, w, cuda)
    y = colorspace.luma(rgb)
    idx = _ranked(h, w, n, cuda)
    before = (k9.LAUNCHES, k6.FORWARD_LAUNCHES)
    t = k9.highest_read(y, idx)
    torch.cuda.synchronize()
    assert (k9.LAUNCHES, k6.FORWARD_LAUNCHES) == (before[0] + 1, before[1])
    assert t.dtype == torch.float32 and t.shape == (2, n)
    g = k9.gates(t, y, idx)
    assert g["within_bound"] and g["within_f64"] and g["finite"], g


@pytest.mark.parametrize("h,w", [(1080, 1920), (1920, 1080)])
def test_highest_read_no_worse_than_the_plain_route(cuda, h, w):
    # Over a batch of ranked reads the 3xTF32 first pass lies no further
    # from the f64 read than cuBLAS's f32 pass does.
    rng = np.random.default_rng(16)
    rgb = torch.from_numpy(rng.integers(0, 256, (4, h, w, 3),
                                        dtype=np.uint8)).to(cuda)
    y = colorspace.luma(rgb)
    idx = tw.prepare_base(rgb, 1000)[1]
    g = k9.gates(k9.highest_read(y, idx), y, idx)
    assert g["within_bound"] and g["no_worse_than_plain"], g


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_highest_read_repeats_and_ignores_the_batch(cuda, h, w):
    # Bit for bit: a second call; each image alone, in other splits of the
    # batch, and with one shared index set; so a Reader's chunk of any size
    # reads what the Writer's verify read.
    rgb, _ = _images(17, h, w, cuda, b=4)
    y = colorspace.luma(rgb)
    idx = _ranked(h, w, 500, cuda, b=4)
    whole = k9.highest_read(y, idx)
    assert torch.equal(whole, k9.highest_read(y, idx))
    for lo, hi in ((0, 1), (1, 4), (2, 3)):
        part = k9.highest_read(y[lo:hi].contiguous(), idx[lo:hi].contiguous())
        assert torch.equal(part, whole[lo:hi])
    shared = k9.highest_read(y, idx[2])
    assert torch.equal(shared[2], whole[2])
    assert torch.equal(k9.highest_read(y, idx[2].expand(4, -1)), shared)


@pytest.mark.parametrize("h,w", [(1080, 1920), (640, 444)])
def test_highest_read_mixed_row_counts_match_each_image_alone(cuda, h, w):
    # One batch: an image whose 1000 indices share one row, one whose
    # indices cover min(n, S) rows, one of random indices; the pass runs a
    # different number of n tiles for each, and each image reads, bit for
    # bit, what it reads alone.
    n = 1000
    rgb, _ = _images(18, h, w, cuda, b=3)
    y = colorspace.luma(rgb)
    idx = _ranked(h, w, n, cuda, b=3)
    s, l = min(h, w), max(h, w)
    a = torch.arange(n, device=cuda) % s
    c = torch.arange(n, device=cuda) % l
    land = h <= w
    idx[0] = 5 * w + c if land else c * w + 5
    idx[1] = a * w + c if land else c * w + a
    whole = k9.highest_read(y, idx)
    g = k9.gates(whole, y, idx)
    assert g["within_bound"] and g["within_f64"] and g["finite"], g
    for i in range(3):
        alone = k9.highest_read(y[i:i + 1].contiguous(),
                                idx[i:i + 1].contiguous())
        assert torch.equal(alone[0], whole[i])


_K9_OUT_OF_RANGE = textwrap.dedent("""
    import torch
    from spread_spectrum_watermarking_torch.kernels import highest_read as k9
    y = torch.zeros((2, 37, 59), device="cuda")
    idx = torch.zeros((2, 64), dtype=torch.int64, device="cuda")
    idx[{image}, 5] = {value}
    k9.highest_read(y, idx)
    torch.cuda.synchronize()
""")


def test_highest_read_raises_at_an_index_out_of_range(cuda):
    # The compaction's device-side assert fails, as K5's does; each bad
    # call runs in a process of its own.
    root = Path(__file__).resolve().parent.parent
    for image, value in ((0, -1), (1, 37 * 59)):
        proc = subprocess.run(
            [sys.executable, "-c",
             _K9_OUT_OF_RANGE.format(image=image, value=value)],
            cwd=root, capture_output=True, text=True, timeout=600)
        assert proc.returncode != 0
        assert "device-side assert" in proc.stderr, proc.stderr[-2000:]
    y = torch.zeros((2, 37, 59), device=cuda)
    idx = _ranked(37, 59, 64, cuda)
    assert bool(k9.highest_read(y, idx).isfinite().all())
    with pytest.raises(ValueError):
        k9.highest_read(y, idx.int())  # int32 indices
    with pytest.raises(ValueError):
        k9.highest_read(y.transpose(1, 2), idx)  # not contiguous
    with pytest.raises(ValueError):
        k9.highest_read(y, idx.cpu())  # CPU/CUDA mix
    with pytest.raises(TypeError):
        k8.luma_u8(y[..., :3])  # not u8


def test_highest_path_goes_through_k8_and_k9(cuda):
    # One HIGHEST embed_verified: K8 twice (the base's and the derived
    # image's luma), K6a, K7 and K9 once; extract reads through K8 twice
    # and K9 once more, bit-equal to embed_verified's read; a float image
    # takes neither.
    rng = np.random.default_rng(19)
    rgb = torch.from_numpy(rng.integers(0, 256, (2, 96, 128, 3),
                                        dtype=np.uint8)).to(cuda)
    marks = torch.from_numpy(rng.standard_normal((2, 1, 200)).astype(
        np.float32)).to(cuda)
    before = (k8.LAUNCHES, k9.LAUNCHES, k6.FORWARD_LAUNCHES, k7.LAUNCHES)
    marked, ext = tw.embed_verified(rgb, marks)
    torch.cuda.synchronize()
    assert (k8.LAUNCHES, k9.LAUNCHES, k6.FORWARD_LAUNCHES, k7.LAUNCHES) == (
        before[0] + 2, before[1] + 1, before[2] + 1, before[3] + 1)
    assert torch.equal(tw.extract(rgb, marked, 200), ext)
    assert (k8.LAUNCHES, k9.LAUNCHES) == (before[0] + 4, before[1] + 2)
    tw.extract(rgb.float() / 255.0, marked.float() / 255.0, 200)
    assert (k8.LAUNCHES, k9.LAUNCHES) == (before[0] + 4, before[1] + 2)

