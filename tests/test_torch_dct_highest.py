"""ops/dct of the port at HIGHEST, and the plain versions of K6a/K6b, against
the JAX package and scipy.

The JAX package has no Pallas at HEAD, so the counterpart of K6a/K6b is
JAX's ``dct2_2d``/``idct2_2d`` at HIGHEST (which the TPU kernels equalled).
Bars: scipy's golden tolerance of ``tests/test_dct.py`` (atol 1e-4 of
max(1, max|want|)), and element by element against JAX the error bound of
two f32 sums of H and W terms taken in another order, 2 (H+W) 2^-24 times
|C_h| |X| |C_w|^T.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

from spread_spectrum_watermarking_tpu.ops import dct as jd
from spread_spectrum_watermarking_torch.config import Precision
from spread_spectrum_watermarking_torch.kernels import _build
from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
from spread_spectrum_watermarking_torch.ops import dct as td

U = 2.0 ** -24
SIZES = [(37, 59), (64, 96), (96, 64), (444, 640)]


def _x(seed, h, w, b=2):
    return np.random.default_rng(seed).standard_normal((b, h, w)).astype(
        np.float32)


def _gamma_bound(x, left, right, scale=1.0, extra=0):
    """2 (H + W + extra) u scale |L| |X| |R|^T, in f64."""
    h, w = x.shape[-2], x.shape[-1]
    a = np.abs(left.astype(np.float64)) @ np.abs(x.astype(np.float64)) @ \
        np.abs(right.astype(np.float64)).T
    return 2 * (h + w + extra) * U * scale * a


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("ortho", [False, True])
def test_dct2_2d_matches_jax_and_scipy(h, w, ortho):
    x = _x(h + w, h, w)
    j = np.asarray(jd.dct2_2d(jnp.asarray(x), ortho=ortho))
    t = td.dct2_2d(torch.from_numpy(x), ortho=ortho).numpy()
    assert t.dtype == np.float32 and t.shape == x.shape
    norm = "ortho" if ortho else None
    want = scipy.fft.dctn(x.astype(np.float64), type=2, axes=(-2, -1),
                          norm=norm)
    tol = 1e-4 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(t, want, rtol=0, atol=tol)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol)
    bound = _gamma_bound(x, td.dct2_basis(h, ortho), td.dct2_basis(w, ortho))
    assert np.all(np.abs(t.astype(np.float64) - j) <= bound)


@pytest.mark.parametrize("h,w", SIZES)
def test_idct2_2d_matches_jax_and_round_trips(h, w):
    x = _x(h * w, h, w)
    c = jd.dct2_2d(jnp.asarray(x))
    j = np.asarray(jd.idct2_2d(c))
    t = td.idct2_2d(torch.from_numpy(np.asarray(c))).numpy()
    np.testing.assert_allclose(t, x, rtol=0, atol=1e-4)
    scale = k6.inverse_scale(h, w)
    # One more rounding on each side: the product by the scale.
    bound = _gamma_bound(np.asarray(c), td.dct3_basis(h), td.dct3_basis(w),
                         scale, extra=1)
    assert np.all(np.abs(t.astype(np.float64) - j) <= bound)


def test_idct2_2d_matches_scipy():
    x = _x(3, 5, 4, b=1)[0]
    t = td.idct2_2d(torch.from_numpy(x)).numpy()
    want = scipy.fft.idctn(x.astype(np.float64), type=2, axes=(-2, -1))
    np.testing.assert_allclose(t, want, rtol=0, atol=1e-4)


def test_plain_versions_keep_jax_association_and_scale():
    x = torch.from_numpy(_x(5, 37, 59))
    ch = torch.from_numpy(td.dct2_basis(37))
    cw = torch.from_numpy(td.dct2_basis(59))
    want = td.matmul_f32(td.matmul_f32(ch, x), cw.t())
    torch.testing.assert_close(k6.dct2_2d_fused_reference(x), want,
                               rtol=0, atol=0)
    dh = torch.from_numpy(td.dct3_basis(37))
    dw = torch.from_numpy(td.dct3_basis(59))
    want = td.matmul_f32(td.matmul_f32(dh, x), dw.t()) * np.float32(
        4.0 / (37 * 59))
    torch.testing.assert_close(k6.idct2_2d_fused_reference(x), want,
                               rtol=0, atol=0)
    assert k6.inverse_scale(37, 59) == float(np.float32(4.0 / (37 * 59)))


def test_cpu_tensors_take_the_plain_versions():
    x = torch.from_numpy(_x(6, 64, 96))
    before = (k6.FORWARD_LAUNCHES, k6.INVERSE_LAUNCHES)
    torch.testing.assert_close(td.dct2_2d(x), k6.dct2_2d_fused_reference(x),
                               rtol=0, atol=0)
    torch.testing.assert_close(td.idct2_2d(x), k6.idct2_2d_fused_reference(x),
                               rtol=0, atol=0)
    assert (k6.FORWARD_LAUNCHES, k6.INVERSE_LAUNCHES) == before
    assert _build._lib is None


def test_unported_tiers_and_fold_raise():
    # Nothing raises any more: every tier is ported (DEFAULT and HIGH:
    # tests/test_torch_dct_high.py), and so are the folded transforms (K1f),
    # which run at each tier and keep the f32 transform's round trip
    # (tests/test_torch_fold.py holds them to JAX).
    x = torch.from_numpy(_x(7, 64, 64))
    for p in Precision:
        c = td.dct2_2d(x, precision=p, fold=True)
        assert c.shape == x.shape and c.dtype == torch.float32
        back = td.idct2_2d(c, precision=p, fold=True)
        tol = 0.1 if p is Precision.DEFAULT else 1e-4
        torch.testing.assert_close(back, x, rtol=0, atol=tol)
        assert td.dct2_2d(x, precision=p).shape == x.shape
        assert td.idct2_2d(x, precision=p).shape == x.shape


@pytest.mark.parametrize("axis", [-2, -1])
def test_dct2_pass_highest_matches_jax(axis):
    x = _x(8, 37, 59)
    j = np.asarray(jd.dct2_pass(jnp.asarray(x), axis=axis))
    t = td.dct2_pass(torch.from_numpy(x), axis=axis)
    assert t.dtype == torch.float32
    k = x.shape[axis]
    basis = np.abs(td.dct2_basis(k).astype(np.float64))
    ax = np.abs(x.astype(np.float64))
    terms = basis @ ax if axis == -2 else ax @ basis.T
    assert np.all(np.abs(t.numpy().astype(np.float64) - j)
                  <= 2 * k * U * terms)


@pytest.mark.parametrize("h,w", [(37, 59), (59, 37)])
def test_dct2_dot_at_highest_matches_jax(h, w):
    x = _x(9, h, w)
    rng = np.random.default_rng(10)
    idx = np.stack([rng.choice(h * w, 150, replace=False) for _ in range(2)])
    for axis in (-2, -1):
        t_plane = jd.dct2_pass(jnp.asarray(x), axis=axis)
        j = np.asarray(jd.dct2_dot_at(t_plane, jnp.asarray(idx, jnp.int32),
                                      contracted_axis=axis))
        t = td.dct2_dot_at(torch.from_numpy(np.asarray(t_plane)),
                           torch.from_numpy(idx), contracted_axis=axis)
        # Dots of K terms |t| |C| <= 2 max|t| in another order.
        k = w if axis == -2 else h
        bound = 2 * k * U * k * 2 * float(np.abs(np.asarray(t_plane)).max())
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=bound)


@pytest.mark.parametrize("h,w", [(5, 4), (4, 5), (8, 8), (48, 64), (64, 48)])
def test_dct2_coeffs_at_matches_full_transform(h, w):
    # As tests/test_dct.py holds the JAX function: equal to gathering the
    # full transform, for H < W, H > W and H == W.
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, h, w)).astype(np.float32)
    n = min(10, h * w)
    idx = np.stack([rng.choice(h * w, n, replace=False) for _ in range(2)])
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    full = torch.gather(td.dct2_2d(tx).reshape(2, -1), -1, ti).numpy()
    sparse = td.dct2_coeffs_at(tx, ti).numpy()
    tol = np.abs(full).max() * 1e-5 + 1e-5
    np.testing.assert_allclose(sparse, full, rtol=0, atol=tol)
    j = np.asarray(jd.dct2_coeffs_at(jnp.asarray(x), jnp.asarray(idx, jnp.int32)))
    np.testing.assert_allclose(sparse, j, rtol=0, atol=tol)
    ortho = td.dct2_coeffs_at(tx, ti, ortho=True).numpy()
    jo = np.asarray(jd.dct2_coeffs_at(jnp.asarray(x), jnp.asarray(idx, jnp.int32),
                                      ortho=True))
    np.testing.assert_allclose(ortho, jo, rtol=0, atol=1e-5)


def test_dct2_coeffs_at_single_image_and_default_raises():
    # DEFAULT no longer raises: it is ported, with bf16 operands, and held
    # here to the full transform at the DEFAULT bound of
    # tests/test_torch_dct_high.py, 2^-5 |C_h| |X| |C_w|^T.
    x = _x(13, 6, 10, b=1)[0]
    idx = np.array([1, 7, 33, 59])
    t = td.dct2_coeffs_at(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    full = np.asarray(jd.dct2_2d(jnp.asarray(x))).reshape(-1)[idx]
    np.testing.assert_allclose(t, full, rtol=0, atol=1e-4)
    d = td.dct2_coeffs_at(torch.from_numpy(x), torch.from_numpy(idx),
                          precision=Precision.DEFAULT).numpy()
    bound = _gamma_bound(x, td.dct2_basis(6), td.dct2_basis(10)) / (
        2 * 16 * U) * 2.0 ** -5
    assert np.all(np.abs(d - full) <= bound.reshape(-1)[idx])
