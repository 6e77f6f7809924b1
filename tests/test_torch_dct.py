"""ops/dct of the port against the JAX package, DEFAULT tier (the HIGHEST
tier is in ``test_torch_dct_highest.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_tpu.config import Precision as JPrecision
from spread_spectrum_watermarking_tpu.ops import dct as jd
from spread_spectrum_watermarking_torch.config import Precision
from spread_spectrum_watermarking_torch.ops import dct as td


def bf16_ulp(x):
    """bf16 spacing at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _plane(seed, h, w):
    x = np.random.default_rng(seed).standard_normal((2, h, w))
    return jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)


def _to_torch(x):
    return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("n", [1, 37, 64, 96])
def test_bases_bit_equal(n):
    np.testing.assert_array_equal(td.dct2_basis(n), jd.dct2_basis(n))
    np.testing.assert_array_equal(td.dct2_basis(n, True), jd.dct2_basis(n, True))
    np.testing.assert_array_equal(td.dct3_basis(n), jd.dct3_basis(n))


@pytest.mark.parametrize("axis", [-2, -1])
def test_dct2_pass_default_within_one_bf16_ulp(axis):
    x = _plane(0, 37, 59)
    j = np.asarray(jd.dct2_pass(x, axis=axis, precision=JPrecision.DEFAULT,
                                out_dtype=jnp.bfloat16).astype(jnp.float32))
    t = td.dct2_pass(_to_torch(x), axis=axis, precision=Precision.DEFAULT,
                     out_dtype=torch.bfloat16).float().numpy()
    # One bf16 rounding of an f32 sum taken in another order.
    assert np.all(np.abs(j - t) <= bf16_ulp(np.maximum(np.abs(j), np.abs(t))))


@pytest.mark.parametrize("axis", [-2, -1])
def test_dct2_dot_at_default_matches(axis):
    x = _plane(1, 37, 59)
    rng = np.random.default_rng(2)
    idx = np.stack([rng.choice(37 * 59, 200, replace=False) for _ in range(2)])
    j = np.asarray(jd.dct2_dot_at(x, jnp.asarray(idx, jnp.int32),
                                  contracted_axis=axis,
                                  precision=JPrecision.DEFAULT))
    t = td.dct2_dot_at(_to_torch(x), torch.from_numpy(idx),
                       contracted_axis=axis,
                       precision=Precision.DEFAULT).numpy()
    # Exact bf16 products, f32 sums in another order: 1e-5 of max|t|.
    scale = float(np.max(np.abs(np.asarray(x.astype(jnp.float32)))))
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * scale)


def test_dct2_pass_takes_only_bf16_planes_and_the_last_two_axes():
    x = _to_torch(_plane(3, 8, 8))
    with pytest.raises(TypeError):
        td.dct2_pass(x.float(), axis=-1, precision=Precision.DEFAULT)
    with pytest.raises(ValueError):
        td.dct2_pass(x, axis=0, precision=Precision.DEFAULT)
