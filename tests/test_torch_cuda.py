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
from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
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


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_luma_pass_kernel_matches_plain(cuda, h, w):
    rgb, near = _images(0, h, w, cuda)
    for base in (None, near):
        before = k1.LAUNCHES
        t = k1.luma_pass(rgb, base).float()
        torch.cuda.synchronize()
        assert k1.LAUNCHES == before + 1
        r = k1.luma_pass_reference(rgb, base).float()
        assert bool(((t - r).abs() <= _k1_bound(rgb, base, t, r)).all())


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_luma_pass_high_kernel_matches_plain(cuda, h, w):
    rgb, _ = _images(4, h, w, cuda)
    before = (k1.LAUNCHES, k1.HIGH_LAUNCHES)
    t = k1.luma_pass(rgb, precision=tw.Precision.HIGH)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES, k1.HIGH_LAUNCHES) == (before[0], before[1] + 1)
    assert t.dtype == torch.bfloat16 and t.shape == rgb.shape[:3]
    t = t.float()
    r = k1.luma_pass_reference(rgb, precision=tw.Precision.HIGH).float()
    assert bool(((t - r).abs() <= _k1_bound(rgb, None, t, r, True)).all())


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



def _k6_bound(x, inverse, ortho=False):
    """2 (H + W) u |L| |X| |R|^T (one more rounding for K6b's scale): two
    f32 sums of H and W terms taken in another order than cuBLAS's."""
    h, w = x.shape[-2], x.shape[-1]
    left = dct.basis_tensor(h, x.device, torch.float32, inverse, ortho).abs()
    right = dct.basis_tensor(w, x.device, torch.float32, inverse, ortho).abs()
    scale = k6.inverse_scale(h, w) if inverse else 1.0
    terms = dct.matmul_f32(dct.matmul_f32(left, x.abs()), right.t())
    return 2 * (h + w + int(inverse)) * 2.0 ** -24 * scale * terms


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_dct2d_kernels_match_plain(cuda, h, w):
    gen = torch.Generator(device=cuda).manual_seed(h * w)
    x = torch.randn((2, h, w), generator=gen, device=cuda)
    cases = [(k6.dct2_2d_fused, lambda v: k6.dct2_2d_fused_reference(v),
              False, False),
             (lambda v: k6.dct2_2d_fused(v, ortho=True),
              lambda v: k6.dct2_2d_fused_reference(v, True), False, True),
             (k6.idct2_2d_fused, k6.idct2_2d_fused_reference, True, False)]
    for kernel, plain, inverse, ortho in cases:
        before = (k6.FORWARD_LAUNCHES, k6.INVERSE_LAUNCHES)
        t = kernel(x)
        torch.cuda.synchronize()
        after = (before[0] + (not inverse), before[1] + inverse)
        assert (k6.FORWARD_LAUNCHES, k6.INVERSE_LAUNCHES) == after
        r = plain(x)
        assert bool(((t - r).abs() <= _k6_bound(x, inverse, ortho)).all())


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
