"""The plain versions of the port's kernels against the JAX package, and
the CPU dispatch rule. The kernels themselves run only on a CUDA card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them against these
plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.config import Precision as JPrecision
from spread_spectrum_watermarking_tpu.models import pipeline as jp
from spread_spectrum_watermarking_tpu.ops import colorspace as jc
from spread_spectrum_watermarking_tpu.ops import dct as jd
from spread_spectrum_watermarking_torch.kernels import _build
from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
from spread_spectrum_watermarking_torch.kernels import luma_pass as k1
from spread_spectrum_watermarking_torch.models import pipeline as tp
from spread_spectrum_watermarking_torch.ops import dct as td

GEOMETRIES = [(64, 96), (96, 64), (37, 59)]


def bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _textures(seed, h, w, b=2):
    rng = np.random.default_rng(seed)
    return np.stack([_pink_texture(rng, h, w) for _ in range(b)])


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_within_ulp(t, j, exact):
    if exact:
        np.testing.assert_array_equal(t, j)
    # One bf16 rounding of an f32 sum taken in another order.
    assert np.all(np.abs(t - j) <= bf16_ulp(np.maximum(np.abs(t), np.abs(j))))


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_luma_pass_single_matches_jax_half_pass(h, w):
    rgb = _textures(0, h, w)
    ax = -2 if h <= w else -1
    j = _f32(jp._half_pass(jnp.asarray(rgb), JPrecision.DEFAULT, ax))
    t = k1.luma_pass_reference(torch.from_numpy(rgb)).float().numpy()
    _assert_within_ulp(t, j, exact=(h, w) == (64, 96))


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_luma_pass_pair_matches_jax_read_tail(h, w):
    base = _textures(1, h, w)
    noise = np.random.default_rng(2).integers(-3, 4, base.shape)
    derived = np.clip(base.astype(int) + noise, 0, 255).astype(np.uint8)
    ax = -2 if h <= w else -1
    ydiff = jc.luma_diff(jnp.asarray(base), jnp.asarray(derived))
    j = _f32(jd.dct2_pass(ydiff.astype(jnp.bfloat16), axis=ax,
                          precision=JPrecision.DEFAULT,
                          out_dtype=jnp.bfloat16))
    t = k1.luma_pass_reference(torch.from_numpy(derived),
                               torch.from_numpy(base)).float().numpy()
    _assert_within_ulp(t, j, exact=(h, w) == (64, 96))


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_embed_epilogue_matches_jax(h, w):
    rng = np.random.default_rng(3)
    rgb = _textures(4, h, w)
    idx = np.stack([rng.choice(h * w - 1, 200, replace=False) + 1
                    for _ in range(2)])
    delta = (rng.standard_normal((2, 200)) * 20.0).astype(np.float32)
    dy = jax.jit(lambda d, i: jp._sparse_idct_delta(d, i, h, w,
                                                    JPrecision.DEFAULT))(
        jnp.asarray(delta), jnp.asarray(idx, jnp.int32))
    j = np.asarray(jax.jit(jc.add_luma_delta_u8)(jnp.asarray(rgb), dy)
                   ).astype(int)
    delta_t, idx_t = torch.from_numpy(delta), torch.from_numpy(idx)
    a, b = td.sparse_idct_factors(delta_t, idx_t, h, w)
    t_dy = tp._sparse_idct_delta(delta_t, idx_t, h, w).float().numpy()
    # dY sums n products that cancel: one bf16 ulp, plus the gamma_n bound
    # of an f32 sum of n terms taken in another order, 2 n 2^-24 sum |a b|.
    abs_sum = np.abs(a.double().numpy()).transpose(0, 2, 1) @ np.abs(
        b.double().numpy())
    bound = (bf16_ulp(np.maximum(np.abs(t_dy), np.abs(_f32(dy))))
             + 2 * 200 * 2.0 ** -24 * abs_sum)
    assert np.all(np.abs(t_dy - _f32(dy)) <= bound)
    t = k4.embed_epilogue_reference(torch.from_numpy(rgb), delta_t,
                                    idx_t).numpy()
    diff = np.abs(t.astype(int) - j)
    assert diff.max() <= 1
    assert np.mean(diff == 0) >= 0.999
    assert np.any(j != rgb)  # the update reached the pixels


def test_cpu_tensors_take_the_plain_path():
    rgb = torch.from_numpy(_textures(5, 37, 59))
    base = torch.from_numpy(_textures(6, 37, 59))
    delta = torch.randn(2, 20)
    idx = torch.randint(0, 37 * 59, (2, 20))
    before = (k1.LAUNCHES, k4.LAUNCHES)
    for mode in (None, base):
        torch.testing.assert_close(k1.luma_pass(rgb, mode),
                                   k1.luma_pass_reference(rgb, mode),
                                   rtol=0, atol=0)
    torch.testing.assert_close(k4.embed_epilogue(rgb, delta, idx),
                               k4.embed_epilogue_reference(rgb, delta, idx),
                               rtol=0, atol=0)
    assert (k1.LAUNCHES, k4.LAUNCHES) == before
    assert _build._lib is None  # nothing was built or loaded


def test_kernel_reciprocals_are_the_ones_xla_multiplies_by():
    """K1 multiplies by f32(1/255) (its u8 table) and f32(1/25500) (pair
    mode, and K5's pair luma), the constants XLA puts in place of the JAX
    code's divisions under jit; the port's colorspace uses the same ones.
    The luma tile pass that both kernels share holds them."""
    import pathlib
    import re

    from spread_spectrum_watermarking_torch.ops import colorspace as tc

    src = (pathlib.Path(k1.__file__).parent.parent / "csrc" /
           "luma_tiles.cuh")
    consts = dict(re.findall(r"constexpr float (kInv\d+) = (0x[0-9a-fp.+-]+)f;",
                             src.read_text()))
    inv255 = np.float32(float.fromhex(consts["kInv255"]))
    inv25500 = np.float32(float.fromhex(consts["kInv25500"]))
    assert (float(inv255), float(inv25500)) == (tc._INV255, tc._INV25500)
    u8 = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(jax.jit(jc.u8_to_f32)(u8)),
                                  u8.astype(np.float32) * inv255)
    num = np.arange(-25500, 25501).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda x: x / 25500.0)(num)), num * inv25500)
