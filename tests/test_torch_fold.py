"""The folded transforms of the port, ``dct2_2d``/``idct2_2d(fold=True)``,
and the plain version of kernel K1f (``kernels.fold_pass``), against the
JAX package at the three tiers.

The fold contracts ``s = x[m] + x[N-1-m]`` and ``d = x[m] - x[N-1-m]``
against the halves of the basis, so its sums of absolute terms are at most
the dense form's, ``A = |L| |X| |R|^T``, and the tiers' bounds of
``tests/test_torch_dct_high.py`` hold, in units of ``A``, with one more f32
rounding per pass on each side (``s`` and ``d``, or the inverse's
``E + O`` and ``E - O``). JAX on the CPU computes every tier in f32 (u =
2^-24):

- HIGHEST: 2 (H + W + 2) u, two f32 transforms in another order;
- HIGH: 2^-12 + 8 (H + W) u (bf16x3, two passes), plus the same;
- DEFAULT: 2^-5 (bf16 operands and intermediate), plus the same;
- the inverse: one more rounding on each side for the scale,
  2 (H + W + 3) u.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_tpu.config import Precision as JPrecision
from spread_spectrum_watermarking_tpu.ops import dct as jd
from spread_spectrum_watermarking_torch.config import Precision
from spread_spectrum_watermarking_torch.kernels import _build
from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
from spread_spectrum_watermarking_torch.kernels import fold_pass as k1f
from spread_spectrum_watermarking_torch.ops import dct as td

U = 2.0 ** -24
# (batch, H, W, ortho): both orientations of the ragged fold (H/2 = 32 and
# 64), and 96x160 (48 and 80) with and without ortho.
CASES = [(2, 64, 128, False), (2, 128, 64, False), (1, 96, 160, False),
         (1, 96, 160, True)]


def _x(seed, b, h, w):
    return np.random.default_rng(seed).standard_normal((b, h, w)).astype(
        np.float32)


def _abs_terms(x, left, right):
    """A = |L| |X| |R|^T in f64."""
    return (np.abs(left.astype(np.float64)) @ np.abs(x.astype(np.float64))
            @ np.abs(right.astype(np.float64)).T)


def _factor(precision, h, w):
    """The port's bound against the exact transform, in units of A."""
    return {Precision.HIGHEST: 0.0,
            Precision.HIGH: 2.0 ** -12 + 8 * (h + w) * U,
            Precision.DEFAULT: 2.0 ** -5}[precision]


def _jax_dct(x, precision, ortho=False, fold=True):
    return np.asarray(jax.jit(lambda v: jd.dct2_2d(
        v, ortho=ortho, precision=JPrecision(precision.value), fold=fold))(
            jnp.asarray(x)))


def _jax_idct(c, precision, fold=True):
    return np.asarray(jax.jit(lambda v: jd.idct2_2d(
        v, precision=JPrecision(precision.value), fold=fold))(jnp.asarray(c)))


@pytest.mark.parametrize("precision", list(Precision))
@pytest.mark.parametrize("b,h,w,ortho", CASES)
def test_dct2_2d_fold_matches_jax(precision, b, h, w, ortho):
    x = _x(h + w + b, b, h, w)
    t = td.dct2_2d(torch.from_numpy(x), ortho=ortho, precision=precision,
                   fold=True)
    assert t.dtype == torch.float32 and t.shape == x.shape
    t = t.numpy().astype(np.float64)
    j = _jax_dct(x, precision, ortho)
    a = _abs_terms(x, td.dct2_basis(h, ortho), td.dct2_basis(w, ortho))
    bound = (_factor(precision, h, w) + 2 * (h + w + 2) * U) * a
    assert np.all(np.abs(t - j) <= bound)
    if precision is Precision.DEFAULT:  # the bf16 rounding shows
        assert np.abs(t - j).max() > 1e-4 * np.abs(j).max()


@pytest.mark.parametrize("precision", list(Precision))
@pytest.mark.parametrize("b,h,w", [c[:3] for c in CASES[:3]])
def test_idct2_2d_fold_matches_jax_and_round_trips(precision, b, h, w):
    x = _x(h * w + b, b, h, w)
    c = _jax_dct(x, Precision.HIGHEST, fold=False)
    t = td.idct2_2d(torch.from_numpy(c.copy()), precision=precision,
                    fold=True).numpy()
    j = _jax_idct(c, precision)
    a = k6.inverse_scale(h, w) * _abs_terms(c, td.dct3_basis(h),
                                            td.dct3_basis(w))
    bound = (_factor(precision, h, w) + 2 * (h + w + 3) * U) * a
    assert np.all(np.abs(t - j) <= bound)
    # The fold's round trip, as tests/test_dct.py holds JAX's (1e-4), and
    # the DEFAULT tolerance of tests/test_torch_dct_high.py.
    back = td.idct2_2d(td.dct2_2d(torch.from_numpy(x), precision=precision,
                                  fold=True), precision=precision, fold=True)
    tol = 0.1 if precision is Precision.DEFAULT else 1e-4
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=tol)


@pytest.mark.parametrize("precision", list(Precision))
@pytest.mark.parametrize("h,w", [(65, 128), (64, 127), (62, 128)])
def test_fold_outside_its_condition_is_the_dense_form(precision, h, w):
    # An odd side, or min(H, W) < 64: the JAX package takes the dense form,
    # and so does the port, bit for bit.
    x = torch.from_numpy(_x(h + 2 * w, 2, h, w))
    torch.testing.assert_close(
        td.dct2_2d(x, precision=precision, fold=True),
        td.dct2_2d(x, precision=precision), rtol=0, atol=0)
    torch.testing.assert_close(
        td.idct2_2d(x, precision=precision, fold=True),
        td.idct2_2d(x, precision=precision), rtol=0, atol=0)
    assert not td._folds(h, w, True) and td._folds(64, 128, True)


@pytest.mark.parametrize("precision", [Precision.DEFAULT, Precision.HIGH])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("ortho", [False, True])
def test_fold_pass_plain_version_is_the_plain_fold(precision, axis, ortho):
    x = torch.from_numpy(_x(3, 2, 64, 96))
    c = torch.from_numpy(td.dct2_basis(x.shape[axis], ortho))
    fold = td._fold_pass_rows if axis == -2 else td._fold_pass_cols
    before = (k1f.LAUNCHES, k1f.HIGH_LAUNCHES)
    got = k1f.fold_pass(x, axis, ortho, precision)
    torch.testing.assert_close(got, fold(x, c, precision), rtol=0, atol=0)
    torch.testing.assert_close(got, k1f.fold_pass_reference(
        x, axis, ortho, precision), rtol=0, atol=0)
    # dct2_2d(fold=True) is the rows pass, then the cols pass.
    cw = torch.from_numpy(td.dct2_basis(96, ortho))
    ch = torch.from_numpy(td.dct2_basis(64, ortho))
    torch.testing.assert_close(
        td.dct2_2d(x, ortho=ortho, precision=precision, fold=True),
        td._fold_pass_cols(td._fold_pass_rows(x, ch, precision), cw,
                           precision), rtol=0, atol=0)
    assert (k1f.LAUNCHES, k1f.HIGH_LAUNCHES) == before
    assert _build._lib is None


@pytest.mark.parametrize("axis", [-2, -1])
def test_fold_pass_is_the_dense_pass(axis):
    # At HIGHEST the fold is the dense 1-D pass up to f32 sums in another
    # order and the rounding of s and d: 2 (N + 1) u sum |C| |x|.
    x = _x(4, 2, 64, 96)
    n = x.shape[axis]
    c = td.dct2_basis(n)
    fold = td._fold_pass_rows if axis == -2 else td._fold_pass_cols
    got = fold(torch.from_numpy(x), torch.from_numpy(c),
               Precision.HIGHEST).numpy()
    dense = td.dct2_pass(torch.from_numpy(x), axis=axis).numpy()
    ax = np.abs(x.astype(np.float64))
    terms = np.abs(c) @ ax if axis == -2 else ax @ np.abs(c).T
    assert np.all(np.abs(got - dense) <= 2 * (n + 1) * U * terms)


@pytest.mark.parametrize("precision", [Precision.DEFAULT, Precision.HIGH])
@pytest.mark.parametrize("axis", [-2, -1])
def test_fold_terms_bound_the_plain_fold(precision, axis):
    # fold_terms is sum |c| |v| over the operands of each output's products,
    # so it bounds |fold| up to the f32 sums' own error (K u, K = N/2 terms,
    # 3N/2 at HIGH). At DEFAULT it is met where every product has one sign:
    # the DC output of a positive plane (at HIGH the lo parts take either).
    x = torch.from_numpy(_x(5, 2, 64, 96)).abs()
    terms = k1f.fold_terms(x, axis, precision)
    got = k1f.fold_pass_reference(x, axis, precision=precision)
    assert terms.shape == x.shape and bool((terms >= 0).all())
    k = x.shape[axis] // 2 * (3 if precision is Precision.HIGH else 1)
    assert bool((got.abs() <= terms * (1 + 2 * k * U)).all())
    if precision is Precision.DEFAULT:
        dc = got[..., 0, :] if axis == -2 else got[..., 0]
        dc_terms = terms[..., 0, :] if axis == -2 else terms[..., 0]
        torch.testing.assert_close(dc, dc_terms, rtol=2 * k * U, atol=0)


def test_fold_bases_are_the_halves_the_plain_products_round():
    cpu = torch.device("cpu")
    c = torch.from_numpy(td.dct2_basis(1080, True))
    halves = torch.stack([c[0::2, :540], c[1::2, :540]])
    hi, lo = k1f._fold_bases(1080, True, cpu, Precision.HIGH)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert hi.shape == lo.shape == (2, 540, 544)  # rows padded to 32
    assert not bool(hi[..., 540:].any()) and not bool(lo[..., 540:].any())
    want_hi, want_lo = td.split_bf16(halves)
    torch.testing.assert_close(hi[..., :540].float(), want_hi, rtol=0, atol=0)
    torch.testing.assert_close(lo[..., :540].float(), want_lo, rtol=0, atol=0)
    d_hi, d_lo = k1f._fold_bases(1080, True, cpu, Precision.DEFAULT)
    assert d_lo is None
    torch.testing.assert_close(d_hi, hi, rtol=0, atol=0)


def test_fold_pass_refuses_what_it_does_not_compute():
    x = torch.zeros((1, 64, 64))
    with pytest.raises(ValueError):
        k1f.fold_pass(x, -2, precision=Precision.HIGHEST)
    with pytest.raises(ValueError):
        k1f.fold_pass(x, 0)
