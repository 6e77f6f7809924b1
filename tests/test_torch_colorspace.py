"""ops/colorspace of the port against the JAX package, on the same u8/f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_tpu.ops import colorspace as jc
from spread_spectrum_watermarking_torch.ops import colorspace as tc


def _images(seed, shape=(2, 37, 59, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_luma_diff_bit_equal():
    # Against the jitted function, as every JAX pipeline runs it: XLA puts
    # the product by f32(1/25500) in place of the division.
    base, derived = _images(0), _images(1)
    j = np.asarray(jax.jit(jc.luma_diff)(jnp.asarray(base),
                                         jnp.asarray(derived)))
    t = tc.luma_diff(torch.from_numpy(base), torch.from_numpy(derived)).numpy()
    np.testing.assert_array_equal(t, j)


def test_u8_to_f32_and_rgb_to_luma_bit_equal_on_every_colour():
    v = np.arange(2 ** 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1)
    rgb = rgb.astype(np.uint8).reshape(256, 256, 256, 3)
    # Jitted, as the pipelines run: u8 / 255 becomes u8 * f32(1/255).
    jf = jax.jit(jc.u8_to_f32)(jnp.asarray(rgb))
    tf = tc.u8_to_f32(torch.from_numpy(rgb))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.rgb_to_luma(tf).numpy(),
                                  np.asarray(jax.jit(jc.rgb_to_luma)(jf)))


def test_f32_to_u8_bit_equal_including_half_steps():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2, 1.2, 4000).astype(np.float32)
    halves = ((np.arange(256) + 0.5) / 255.0).astype(np.float32)
    x = np.concatenate([x, halves, np.float32([0.0, 1.0, -0.0])])
    j = np.asarray(jc.f32_to_u8(jnp.asarray(x)))
    t = tc.f32_to_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_luma_delta_u8_bit_equal(dtype):
    rgb = _images(4)
    dy = np.random.default_rng(5).normal(0.0, 0.01, rgb.shape[:-1])
    dy = np.concatenate([dy.ravel()[:-2], [2.0, -2.0]]).reshape(dy.shape)
    jdy = jnp.asarray(dy, jnp.float32).astype(dtype)
    j = np.asarray(jc.add_luma_delta_u8(jnp.asarray(rgb), jdy))
    tdy = torch.from_numpy(np.asarray(jdy.astype(jnp.float32))).to(
        getattr(torch, dtype))
    t = tc.add_luma_delta_u8(torch.from_numpy(rgb), tdy).numpy()
    np.testing.assert_array_equal(t, j)


def test_rgb_to_yiq_bit_equal_to_jit_on_every_colour():
    # Under jax.jit (as the pipelines run it) XLA sums each row as
    # fma(m2, b, fma(m0, r, m1*g)); the port reproduces that order.
    v = np.arange(2 ** 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1)
    rgb = rgb.astype(np.uint8).reshape(256, 256, 256, 3)
    jf = np.asarray(jax.jit(jc.u8_to_f32)(jnp.asarray(rgb)))
    j = np.asarray(jax.jit(jc.rgb_to_yiq)(jf))
    t = tc.rgb_to_yiq(torch.from_numpy(jf)).numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))


def test_yiq_to_rgb_bit_equal_to_jit_on_random_triples():
    # Two million triples over and beyond the YIQ range, so that the clamp
    # and both signs of every term are reached.
    rng = np.random.default_rng(6)
    yiq = rng.uniform(-1.5, 2.5, (2_000_000, 3)).astype(np.float32)
    j = np.asarray(jax.jit(jc.yiq_to_rgb)(jnp.asarray(yiq)))
    t = tc.yiq_to_rgb(torch.from_numpy(yiq)).numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    assert 0.0 < np.mean((j > 0.0) & (j < 1.0)) < 1.0


def test_fma_emulation_is_correctly_rounded_where_f64_rounds_twice():
    # a*m + acc = 1 + 2^-24 + 2^-60 (first case) and 1 + 3*2^-24 - 2^-60
    # (second): each lies just off an f32 midpoint, and its f64 sum lands on
    # the midpoint, so rounding the f64 sum to f32 would round twice and go
    # the wrong way. Both round correctly to 1 + 2^-23.
    m = 1.0 - 2.0 ** -18
    acc = torch.tensor([1.0 + 2.0 ** -23], dtype=torch.float32)
    want = np.float32(1.0 + 2.0 ** -23)
    for sign in (-1.0, 1.0):
        a = torch.tensor([sign * 2.0 ** -24 * (1.0 + 2.0 ** -18)],
                         dtype=torch.float32)
        naive = (a.double() * m + acc.double()).float()
        assert naive.item() != want
        assert tc._fma_f32(a, m, acc).item() == want


def test_luma_u8_table_bit_equal_to_jax_on_every_colour():
    v = np.arange(2 ** 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1)
    rgb = rgb.astype(np.uint8).reshape(4096, 4096, 3)
    j = np.asarray(jax.jit(lambda x: jc.rgb_to_luma(jc.u8_to_f32(x)))(
        jnp.asarray(rgb)))
    t = tc.luma_u8(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    with pytest.raises(TypeError):
        tc.luma_u8(torch.from_numpy(rgb[:2]).float())


def test_add_luma_delta_f32_rounds_once_as_jitted_jax():
    # The HIGHEST (and fast-tier float-output) epilogue. Under jit XLA
    # contracts u8 * f32(1/255) + dY into one FMA; the helper rounds once
    # and is bit-equal over every u8 value and dY of both signs from 1e-8
    # to 0.1. The product and the sum rounded apart (the form CUDA tensors
    # keep) is not.
    mags = np.logspace(-8, -1, 300).astype(np.float32)
    noise = np.random.default_rng(0).standard_normal(400) * 3e-3
    d = np.concatenate([mags, -mags, noise]).astype(np.float32)
    u = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None],
                        (256, d.size, 3)).copy()
    dd = np.broadcast_to(d[None, :], (256, d.size)).copy()
    j = np.asarray(jax.jit(
        lambda a, b: jnp.clip(jc.u8_to_f32(a) + b[..., None], 0.0, 1.0))(
            jnp.asarray(u), jnp.asarray(dd)))
    tu, td_ = torch.from_numpy(u), torch.from_numpy(dd)
    t = tc.add_luma_delta_f32(tu, td_).numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    twice = torch.clamp(tc.u8_to_f32(tu) + td_[..., None], 0.0, 1.0).numpy()
    assert np.any(twice != j)
    # Float images add in f32, as the JAX package does.
    f = u.astype(np.float32) / 255.0
    jf = np.asarray(jax.jit(lambda a, b: jnp.clip(a + b[..., None], 0.0, 1.0))(
        jnp.asarray(f), jnp.asarray(dd)))
    np.testing.assert_array_equal(
        tc.add_luma_delta_f32(torch.from_numpy(f), td_).numpy(), jf)


@pytest.mark.parametrize("kinds", [("u8", "f32"), ("f32", "u8"),
                                   ("f32", "f32")])
def test_luma_diff_of_float_images_bit_equal(kinds):
    # Any float image takes the JAX package's other branch: the difference
    # of the two f32 lumas (u8 through u8_to_f32).
    base, derived = _images(2), _images(3)
    pair = [x if k == "u8" else (x.astype(np.float32) / 255.0)
            for x, k in zip((base, derived), kinds)]
    j = np.asarray(jax.jit(jc.luma_diff)(*map(jnp.asarray, pair)))
    t = tc.luma_diff(*map(torch.from_numpy, pair)).numpy()
    np.testing.assert_array_equal(t, j)
