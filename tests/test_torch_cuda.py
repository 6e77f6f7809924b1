"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked ``cuda`` and skips without a card. This file
imports the port, torch and numpy only, so it also runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_cuda.py`` (the
suite's ``conftest.py`` imports JAX).
"""

import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_torch.kernels import add_quantize as k7
from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
from spread_spectrum_watermarking_torch.kernels import fold_pass as k1f
from spread_spectrum_watermarking_torch.kernels import luma_pass as k1
from spread_spectrum_watermarking_torch.models import pipeline as tp
from spread_spectrum_watermarking_torch.ops import colorspace, dct

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


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_embed_epilogue_kernel_matches_plain(cuda, h, w):
    gen = torch.Generator(device=cuda).manual_seed(0)
    rgb, _ = _images(1, h, w, cuda)
    idx = torch.randint(1, h * w, (2, 200), generator=gen, device=cuda)
    delta = torch.randn((2, 200), generator=gen, device=cuda) * 20.0
    a, b = tp._sparse_idct_factors(delta, idx, h, w)
    before = k4.LAUNCHES
    t = k4.embed_epilogue(rgb, a, b).int()
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1
    r = k4.embed_epilogue_reference(rgb, a, b).int()
    assert int((t - r).abs().max()) <= 1


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rgb, near = _images(2, 37, 59, cuda)
    a = torch.zeros((2, 4, 37), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros((2, 4, 59), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        k1.luma_pass(rgb.transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        k1.luma_pass(rgb, near[:1])  # base of another shape
    with pytest.raises(ValueError):
        k4.embed_epilogue(rgb, a.float(), b)  # f32 factor
    with pytest.raises(ValueError):
        k4.embed_epilogue(rgb, a.cpu(), b)  # factor on another device


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
    before = (k1.LAUNCHES, k1.HIGH_LAUNCHES, k4.LAUNCHES)
    g_marked, g_ext = tw.embed_verified(torch.from_numpy(rgb).to(cuda),
                                        torch.from_numpy(marks).to(cuda), cfg)
    torch.cuda.synchronize()
    # K1's high mode (base), its pair mode (read tail), K4 (epilogue).
    assert (k1.LAUNCHES, k1.HIGH_LAUNCHES, k4.LAUNCHES) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
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
    # of four pixels, a tail, and a misaligned start (the scalar path).
    gen = torch.Generator(device=cuda).manual_seed(npix)
    rgb = torch.randint(0, 256, (npix + 1, 3), generator=gen, device=cuda,
                        dtype=torch.uint8)
    dy = torch.randn((npix + 1,), generator=gen, device=cuda) * 0.02
    for r, d in ((rgb[:npix], dy[:npix]), (rgb[1:], dy[1:])):
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
