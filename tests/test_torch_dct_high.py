"""ops/dct of the port at the fast tiers (HIGH and DEFAULT), and the plain
version of K1's high mode, against the JAX package and scipy.

JAX on the CPU computes every tier as f32 (the CPU backend does not round
operands to bf16), so the port's bf16 products are held to bounds derived
from where they round, element by element, in units of ``|L| |X| |R|^T``
(the sum of the absolute terms, ``A`` below):

- HIGH (bf16x3): each operand is ``hi + lo + e`` with ``|lo| <= 2^-8 |x|``
  and ``|e| <= 2^-16 |x|`` (bf16 keeps 8 bits, u_bf16 = 2^-8); the three
  kept products miss ``lo*lo`` and the ``e`` terms, at most
  ``3 * 2^-16 (1 + 2^-8) + 2^-24 < 2^-14`` of each product's magnitude; a
  pass sums 3K exact products in f32 (``3K u``, u = 2^-24, on sums of
  magnitude at most ``(1 + 2^-7) A``) and JAX's f32 sum adds ``K u``.
  Stated bound per pass: ``(2^-14 + 8K u) A``; two passes:
  ``(2^-12 + 8 (H + W) u) A``.
- DEFAULT (bf16 operands, f32 sums): each product is off by at most
  ``2^-7 + 2^-16`` of its magnitude; the second pass also rounds the f32
  intermediate to bf16, so two passes stay under ``2^-6 (1 + 2^-7) A``
  plus the f32 sums. Stated bound: ``2^-5 A`` (``2^-6 A`` for one pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.config import Precision as JPrecision
from spread_spectrum_watermarking_tpu.models import pipeline as jp
from spread_spectrum_watermarking_tpu.ops import dct as jd
from spread_spectrum_watermarking_torch.config import Precision
from spread_spectrum_watermarking_torch.kernels import _build
from spread_spectrum_watermarking_torch.kernels import _tiles
from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
from spread_spectrum_watermarking_torch.kernels import luma_pass as k1
from spread_spectrum_watermarking_torch.ops import colorspace as tc
from spread_spectrum_watermarking_torch.ops import dct as td

U = 2.0 ** -24
SIZES = [(37, 59), (64, 96), (96, 64)]
FAST = [Precision.DEFAULT, Precision.HIGH]


def _x(seed, h, w, b=2):
    return np.random.default_rng(seed).standard_normal((b, h, w)).astype(
        np.float32)


def _abs_terms(x, left, right):
    """A = |L| |X| |R|^T in f64."""
    return (np.abs(left.astype(np.float64)) @ np.abs(x.astype(np.float64))
            @ np.abs(right.astype(np.float64)).T)


def _factor(precision, h, w):
    """The stated bound of a two-pass transform, in units of A."""
    if precision is Precision.HIGH:
        return 2.0 ** -12 + 8 * (h + w) * U
    return 2.0 ** -5


def bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_matmul_bf16x3_is_the_three_products_summed_in_f32():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 9, 70)).astype(np.float32)
    b = rng.standard_normal((70, 11)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    a_hi, a_lo = (v.double().numpy() for v in td.split_bf16(ta))
    b_hi, b_lo = (v.double().numpy() for v in td.split_bf16(tb))
    # The split: bf16 values; lo is the residual rounded to bf16.
    assert np.array_equal(a_hi.astype(np.float32),
                          ta.to(torch.bfloat16).float().numpy())
    assert np.all(np.abs(a_lo) <= 2.0 ** -8 * np.abs(a))
    assert np.all(np.abs(a - a_hi - a_lo) <= 2.0 ** -16 * np.abs(a))
    exact = a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    terms = np.abs(a_hi) @ np.abs(b_hi) + np.abs(a_hi) @ np.abs(b_lo) \
        + np.abs(a_lo) @ np.abs(b_hi)
    got = td.matmul_bf16x3(ta, tb).numpy()
    assert got.dtype == np.float32
    assert np.all(np.abs(got - exact) <= 2 * 3 * 70 * U * terms)
    # and the whole product within the HIGH bound of a @ b
    full = a.astype(np.float64) @ b.astype(np.float64)
    bound = (2.0 ** -14 + 8 * 70 * U) * (np.abs(a) @ np.abs(b))
    assert np.all(np.abs(got - full) <= bound)
    # DEFAULT: bf16 operands, exact products, f32 sums.
    d = td.matmul(ta, tb, Precision.DEFAULT).numpy()
    want = a_hi @ b_hi
    assert np.all(np.abs(d - want) <= 2 * 70 * U * (np.abs(a_hi) @ np.abs(b_hi)))


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("h,w", [(37, 59), (64, 96)])
def test_dct2_pass_high_matches_jax(axis, h, w):
    x = _x(h + w, h, w)
    j = np.asarray(jax.jit(lambda v: jd.dct2_pass(
        v, axis=axis, precision=JPrecision.HIGH))(jnp.asarray(x)))
    t = td.dct2_pass(torch.from_numpy(x), axis=axis, precision=Precision.HIGH)
    assert t.dtype == torch.float32
    k = x.shape[axis]
    c = td.dct2_basis(k)
    a = np.abs(c.astype(np.float64)) @ np.abs(x.astype(np.float64)) \
        if axis == -2 else np.abs(x.astype(np.float64)) @ np.abs(c.T)
    bound = (2.0 ** -14 + 8 * k * U) * a
    assert np.all(np.abs(t.numpy().astype(np.float64) - j) <= bound)


def test_dct2_2d_high_close_to_highest():
    # As tests/test_dct.py holds the JAX tiers: HIGH within 1e-5 of the
    # plane's largest value from HIGHEST, on image-like data.
    x = np.random.default_rng(5).random((64, 48), dtype=np.float32)
    hi = td.dct2_2d(torch.from_numpy(x)).numpy()
    mid = td.dct2_2d(torch.from_numpy(x), precision=Precision.HIGH).numpy()
    assert np.abs(hi - mid).max() / np.abs(hi).max() < 1e-5


@pytest.mark.parametrize("precision", FAST)
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("ortho", [False, True])
def test_dct2_2d_fast_tiers_match_jax_and_scipy(precision, h, w, ortho):
    x = _x(h * w, h, w)
    t = td.dct2_2d(torch.from_numpy(x), ortho=ortho, precision=precision)
    assert t.dtype == torch.float32 and t.shape == x.shape
    t = t.numpy().astype(np.float64)
    j = np.asarray(jax.jit(lambda v: jd.dct2_2d(
        v, ortho=ortho, precision=JPrecision(precision.value)))(
            jnp.asarray(x)))
    want = scipy.fft.dctn(x.astype(np.float64), type=2, axes=(-2, -1),
                          norm="ortho" if ortho else None)
    a = _abs_terms(x, td.dct2_basis(h, ortho), td.dct2_basis(w, ortho))
    bound = _factor(precision, h, w) * a
    assert np.all(np.abs(t - want) <= bound)
    assert np.all(np.abs(t - j) <= bound + 2 * (h + w) * U * a)
    # The bf16 rounding shows: DEFAULT is not the f32 transform.
    if precision is Precision.DEFAULT:
        assert np.abs(t - want).max() > 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("precision", FAST)
@pytest.mark.parametrize("h,w", SIZES)
def test_idct2_2d_fast_tiers_match_jax_and_round_trip(precision, h, w):
    x = _x(h * w + 1, h, w)
    c = np.asarray(jd.dct2_2d(jnp.asarray(x)))
    t = td.idct2_2d(torch.from_numpy(c), precision=precision).numpy()
    j = np.asarray(jax.jit(lambda v: jd.idct2_2d(
        v, precision=JPrecision(precision.value)))(jnp.asarray(c)))
    a = k6.inverse_scale(h, w) * _abs_terms(c, td.dct3_basis(h),
                                            td.dct3_basis(w))
    bound = _factor(precision, h, w) * a
    # One more rounding on each side: the product by the scale.
    assert np.all(np.abs(t - j) <= bound + 2 * (h + w + 1) * U * a)
    want = scipy.fft.idctn(c.astype(np.float64), type=2, axes=(-2, -1))
    assert np.all(np.abs(t - want) <= bound + 2 * (h + w + 1) * U * a)
    tol = 1e-4 if precision is Precision.HIGH else 0.1
    np.testing.assert_allclose(t, x, rtol=0, atol=tol)


@pytest.mark.parametrize("contracted", [-2, -1])
def test_dct2_dot_at_all_tiers_match_jax(contracted):
    # The shared-index case of tests/test_dct.py at its tier tolerances,
    # then element by element against JAX's own dots at each tier.
    rng = np.random.default_rng(7)
    y = rng.normal(size=(3, 16, 24)).astype(np.float32)
    idx = np.array([1, 5, 100, 383])
    exact = np.asarray(jd.dct2_2d(jnp.asarray(y))).reshape(3, -1)[:, idx]
    t_plane = np.asarray(jd.dct2_pass(jnp.asarray(y), axis=contracted))
    k = 24 if contracted == -2 else 16
    other = td.dct2_basis(k)
    for p, rtol, atol in ((Precision.HIGHEST, 1e-5, 1e-5),
                          (Precision.HIGH, 1e-4, 1e-3),
                          (Precision.DEFAULT, 3e-2, 0.2)):
        got = td.dct2_dot_at(torch.from_numpy(t_plane), torch.from_numpy(idx),
                             contracted_axis=contracted, precision=p).numpy()
        assert got.shape == (3, 4)
        np.testing.assert_allclose(got, exact, rtol=rtol, atol=atol)
        j = np.asarray(jax.jit(lambda v, i: jd.dct2_dot_at(
            v, i, contracted_axis=contracted,
            precision=JPrecision(p.value)))(jnp.asarray(t_plane),
                                            jnp.asarray(idx, jnp.int32)))
        # sum over the dot's K terms of |t| |C|, for each index
        rows, cols = idx // 24, idx % 24
        if contracted == -2:
            a = np.abs(t_plane[:, rows, :]) @ np.abs(other).T
            a = a[:, np.arange(4), cols]
        else:
            a = np.abs(other) @ np.abs(t_plane[:, :, cols])
            a = a[:, rows, np.arange(4)]
        factor = {Precision.HIGHEST: 4 * k * U,
                  Precision.HIGH: 2.0 ** -14 + 8 * k * U,
                  Precision.DEFAULT: 2.0 ** -6}[p]
        assert np.all(np.abs(got - j) <= factor * a + 1e-30)


@pytest.mark.parametrize("precision", list(Precision))
@pytest.mark.parametrize("h,w", [(16, 24), (24, 16)])
def test_dct2_coeffs_at_all_tiers_match_jax(precision, h, w):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, h, w)).astype(np.float32)
    idx = np.stack([rng.choice(h * w, 20, replace=False) for _ in range(2)])
    got = td.dct2_coeffs_at(torch.from_numpy(x), torch.from_numpy(idx),
                            precision=precision).numpy()
    j = np.asarray(jax.jit(lambda v, i: jd.dct2_coeffs_at(
        v, i, precision=JPrecision(precision.value)))(
            jnp.asarray(x), jnp.asarray(idx, jnp.int32)))
    a = np.take_along_axis(
        _abs_terms(x, td.dct2_basis(h), td.dct2_basis(w)).reshape(2, -1),
        idx, -1)
    factor = (4 * (h + w) * U if precision is Precision.HIGHEST
              else _factor(precision, h, w) + 2 * (h + w) * U)
    assert np.all(np.abs(got - j) <= factor * a)


@pytest.mark.parametrize("kind,equal", [("pink", 0.96), ("random", 0.99)])
@pytest.mark.parametrize("h,w", SIZES)
def test_luma_pass_high_plain_matches_jax_half_pass(kind, equal, h, w):
    # JAX on the CPU computes the HIGH pass in f32; bf16x3 keeps about 16
    # bits, so where the pass cancels (the high frequencies of smooth
    # textures) the bf16 rounding of the two can differ by more than an
    # ulp. Each element is held to one bf16 ulp plus the one-pass HIGH
    # bound (2^-14 + 8K u) sum_k |C y|; the share of bf16-equal elements
    # (measured 0.971-0.974 on textures, 0.991-0.992 on random pixels) to
    # ``equal``.
    rng = np.random.default_rng(h)
    if kind == "pink":
        rgb = np.stack([_pink_texture(rng, h, w) for _ in range(2)])
    else:
        rgb = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    ax = -2 if h <= w else -1
    j = np.asarray(jax.jit(lambda v: jp._half_pass(
        v, JPrecision.HIGH, ax).astype(jnp.bfloat16).astype(jnp.float32))(
            jnp.asarray(rgb)))
    t = k1.luma_pass_reference(torch.from_numpy(rgb),
                               precision=Precision.HIGH)
    assert t.dtype == torch.bfloat16 and t.shape == rgb.shape[:3]
    t = t.float().numpy()
    assert np.mean(t == j) >= equal
    y = np.abs(tc.luma_u8(torch.from_numpy(rgb)).double().numpy())
    k = min(h, w)
    c = np.abs(td.dct2_basis(k).astype(np.float64))
    a = c @ y if ax == -2 else y @ c.T
    bound = bf16_ulp(np.maximum(np.abs(t), np.abs(j))) \
        + (2.0 ** -14 + 8 * k * U) * a
    assert np.all(np.abs(t - j) <= bound)


def test_luma_pass_high_on_the_cpu_and_the_modes_it_refuses():
    rgb = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 37, 59, 3), dtype=np.uint8))
    before = (k1.LAUNCHES, k1.HIGH_LAUNCHES)
    torch.testing.assert_close(
        k1.luma_pass(rgb, precision=Precision.HIGH),
        k1.luma_pass_reference(rgb, precision=Precision.HIGH), rtol=0, atol=0)
    assert (k1.LAUNCHES, k1.HIGH_LAUNCHES) == before
    assert _build._lib is None
    with pytest.raises(ValueError):
        k1.luma_pass(rgb, rgb, precision=Precision.HIGH)  # pair mode at HIGH
    with pytest.raises(ValueError):
        k1.luma_pass(rgb, precision=Precision.HIGHEST)
    # The HIGH basis split is the one matmul_bf16x3 forms, in the kernel's
    # tile image: hi part, then lo part.
    tiles = k1._basis_tiles(37, torch.device("cpu"), Precision.HIGH)
    assert tiles.shape == (2, 1, 1, 128, 64)
    hi, lo = _tiles.untile_image(tiles, 37, 37)
    c = torch.from_numpy(td.dct2_basis(37))
    assert hi.dtype == lo.dtype == torch.bfloat16
    torch.testing.assert_close(hi.float() + lo.float(), c, rtol=0,
                               atol=float(2.0 ** -17))
