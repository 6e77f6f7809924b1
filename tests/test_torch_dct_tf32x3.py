"""The 3xTF32 arithmetic of K6a/K6b, emulated in plain PyTorch on the CPU,
against the JAX package's HIGHEST transforms.

On the card K6a/K6b split every f32 operand into two TF32 parts, ``hi =
rna(a)`` and ``lo = rna(a - hi)`` (round to 10 explicit mantissa bits, ties
away from zero), and sum three products of the parts in f32.
``kernels.dct2d_fused.split_tf32`` and ``dct2_2d_tf32x3_reference`` /
``idct2_2d_tf32x3_reference`` do the same on the CPU. The tolerance is
pinned here: per element, ``(2 (H + W) + 25 + [inverse]) 2^-24 s |L| |X|
|R|^T``, two f32 sums of H and W terms in another order than JAX's, 25 for
the split (at most 12 (1 + 2^-10) of ``|a| |b|`` per product and pass), one
more rounding for the inverse's scale ``s``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.config import Ordering as JOrdering
from spread_spectrum_watermarking_tpu.models import pipeline as jp
from spread_spectrum_watermarking_tpu.ops import dct as jd
from spread_spectrum_watermarking_tpu.ops import ranking as jr
from spread_spectrum_watermarking_torch.config import Ordering
from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
from spread_spectrum_watermarking_torch.ops import colorspace, ranking
from spread_spectrum_watermarking_torch.ops import dct as td

U = 2.0 ** -24
SPLIT = 25  # the split's term, pinned
SHAPES = [(2, 37, 59), (2, 64, 96), (1, 444, 640)]


def _bits(x):
    return torch.as_tensor(x, dtype=torch.float32).view(torch.int32).numpy()


def _edge_values():
    """Normal values over many binades, subnormals, +-0, and values at,
    just below and just above a rounding tie of TF32, both signs."""
    rng = np.random.default_rng(0)
    normal = (rng.standard_normal(4000) * np.exp2(rng.integers(-120, 120, 4000))
              ).astype(np.float32)
    sub = (rng.standard_normal(500) * 2.0 ** -140).astype(np.float32)
    tie_bits = (rng.integers(0x00800000 >> 13, 0x7F000000 >> 13, 500) << 13
                | 0x1000).astype(np.int32)
    ties = tie_bits.view(np.float32)
    near = np.concatenate([(tie_bits - 1).view(np.float32),
                           (tie_bits + 1).view(np.float32)])
    vals = np.concatenate([normal, sub, ties, near, [0.0, -0.0,
                                                     1.0 + 2.0 ** -11]])
    return np.concatenate([vals, -vals]).astype(np.float32)


def _rna_f64(a):
    """RNA to 11 significant bits, computed in f64 for normal f32 ``a``."""
    a = a.astype(np.float64)
    _, e = np.frexp(a)  # |a| in [2^(e-1), 2^e)
    step = np.ldexp(1.0, e - 11)
    return np.sign(a) * np.floor(np.abs(a) / step + 0.5) * step


def test_split_parts_are_tf32():
    hi, lo = k6.split_tf32(torch.from_numpy(_edge_values()))
    assert np.all(_bits(hi) & 0x1FFF == 0)
    assert np.all(_bits(lo) & 0x1FFF == 0)


def test_split_sums_back_within_2_to_minus_22():
    a = _edge_values()
    hi, lo = k6.split_tf32(torch.from_numpy(a))
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - a)
    # Relative where lo is normal; below that, lo's rounding is at TF32's
    # subnormal step 2^-136, so at most half of it.
    assert np.all(err <= np.maximum(2.0 ** -22 * np.abs(a), 2.0 ** -137))
    normal = np.abs(a) >= 2.0 ** -100
    assert np.all(err[normal] <= 2.0 ** -22 * np.abs(a[normal]))
    # Signed zeros stay zeros of their sign in hi.
    z, _ = k6.split_tf32(torch.tensor([0.0, -0.0]))
    assert _bits(z).tolist() == [0, -2 ** 31]


def test_split_rounds_to_nearest_ties_away_from_zero():
    a = _edge_values()
    normal = a[np.abs(a) >= 2.0 ** -126]
    hi, lo = k6.split_tf32(torch.from_numpy(normal))
    np.testing.assert_array_equal(hi.numpy().astype(np.float64),
                                  _rna_f64(normal))
    r = normal.astype(np.float64) - hi.numpy()  # exact in f32
    big = np.abs(r) >= 2.0 ** -126
    np.testing.assert_array_equal(lo.numpy()[big].astype(np.float64),
                                  _rna_f64(r[big].astype(np.float32)))
    # A tie goes away from zero (round-to-even would keep 1.0).
    hi, lo = k6.split_tf32(torch.tensor([1.0 + 2.0 ** -11, -1.0 - 2.0 ** -11]))
    assert hi.tolist() == [1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10]
    assert lo.tolist() == [-2.0 ** -11, 2.0 ** -11]


def _abs_transform_f64(x, left, right, scale=1.0):
    return scale * (np.abs(left.astype(np.float64)) @ np.abs(x.astype(np.float64))
                    @ np.abs(right.astype(np.float64)).T)


def _pinned_bound(x, left, right, scale=1.0, inverse=False):
    h, w = x.shape[-2], x.shape[-1]
    terms = 2 * (h + w) + SPLIT + int(inverse)
    return terms * U * _abs_transform_f64(x, left, right, scale)


@functools.lru_cache(maxsize=None)
def _jax_dct(ortho):
    return jax.jit(functools.partial(jd.dct2_2d, ortho=ortho))


_jax_idct = jax.jit(jd.idct2_2d)


def _x(seed, b, h, w):
    return np.random.default_rng(seed).standard_normal((b, h, w)).astype(
        np.float32)


@pytest.mark.parametrize("b,h,w", SHAPES)
@pytest.mark.parametrize("ortho", [False, True])
def test_emulated_forward_within_tolerance_of_jax(b, h, w, ortho):
    x = _x(h + w + ortho, b, h, w)
    j = np.asarray(_jax_dct(ortho)(jnp.asarray(x)))
    t = k6.dct2_2d_tf32x3_reference(torch.from_numpy(x), ortho).numpy()
    assert t.dtype == np.float32 and t.shape == x.shape
    bound = _pinned_bound(x, td.dct2_basis(h, ortho), td.dct2_basis(w, ortho))
    assert np.all(np.abs(t.astype(np.float64) - j) <= bound)
    # The split is not f32: it differs from the plain f32 products.
    assert not np.array_equal(t, k6.dct2_2d_fused_reference(
        torch.from_numpy(x), ortho).numpy())


@pytest.mark.parametrize("b,h,w", SHAPES)
def test_emulated_inverse_within_tolerance_of_jax(b, h, w):
    c = np.array(_jax_dct(False)(jnp.asarray(_x(h * w, b, h, w))))
    j = np.asarray(_jax_idct(jnp.asarray(c)))
    t = k6.idct2_2d_tf32x3_reference(torch.from_numpy(c)).numpy()
    bound = _pinned_bound(c, td.dct3_basis(h), td.dct3_basis(w),
                          k6.inverse_scale(h, w), inverse=True)
    assert np.all(np.abs(t.astype(np.float64) - j) <= bound)


@pytest.mark.parametrize("inverse,ortho", [(False, False), (False, True),
                                           (True, False)])
def test_k6_bound_is_the_pinned_tolerance(inverse, ortho):
    x = _x(9, 2, 37, 59)
    if inverse:
        left, right = td.dct3_basis(37), td.dct3_basis(59)
        scale = k6.inverse_scale(37, 59)
    else:
        left, right = td.dct2_basis(37, ortho), td.dct2_basis(59, ortho)
        scale = 1.0
    want = _pinned_bound(x, left, right, scale, inverse)
    got = k6.k6_bound(torch.from_numpy(x), inverse, ortho).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_emulated_ranking_agrees_with_jax_but_near_ties():
    n, h, w = 1000, 444, 640
    rng = np.random.default_rng(21)
    rgb = np.stack([_pink_texture(rng, h, w) for _ in range(2)])
    j_plane = np.asarray(jax.jit(jp._forward, static_argnums=1)(
        jnp.asarray(rgb), jp.Precision.HIGHEST))
    y = colorspace.luma(torch.from_numpy(rgb))
    t_plane = k6.dct2_2d_tf32x3_reference(y)
    j_idx = np.asarray(jax.jit(jr.top_indices, static_argnums=(1, 2))(
        jnp.asarray(j_plane), n, JOrdering.ENERGY))
    t_idx = ranking.top_indices(t_plane, n, Ordering.ENERGY).numpy()
    differ = t_idx != j_idx
    assert differ.mean() <= 0.01
    # Sorted lists of planes within d of each other differ by at most d at
    # every rank, so two indices at one rank are within 2 d on one plane.
    ynp = y.numpy()
    d = _pinned_bound(ynp, td.dct2_basis(h), td.dct2_basis(w)).reshape(
        2, -1).max(axis=1, keepdims=True)
    mag = np.abs(j_plane.reshape(2, -1).astype(np.float64))
    gap = np.abs(np.take_along_axis(mag, t_idx, 1)
                 - np.take_along_axis(mag, j_idx, 1))
    assert np.all(gap[differ] <= 2 * np.broadcast_to(d, gap.shape)[differ])
