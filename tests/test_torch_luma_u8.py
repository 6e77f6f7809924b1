"""K8, the u8 luma, on the CPU: its plain version (the table of every
colour's luma) against the JAX package's ``rgb_to_luma(u8_to_f32(x))``, an
emulation of the kernel's 512-pixel tile path and its byte path against
the plain version, the constants its source computes with, and the
wrapper's CPU dispatch and checks. The kernel itself runs only on a CUDA
card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it to its
plain version there, bit for bit over all 2^24 colours."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_torch import Precision, WriteConfig
from spread_spectrum_watermarking_torch.kernels import launch_counts
from spread_spectrum_watermarking_torch.kernels import luma_u8 as k8
from spread_spectrum_watermarking_torch.models import pipeline as tp
from spread_spectrum_watermarking_torch.ops import colorspace as tc
from spread_spectrum_watermarking_tpu.ops import colorspace as jc

SOURCE = (Path(tc.__file__).resolve().parent.parent / "csrc" / "luma_u8.cu")
GEOMETRIES = [(64, 96), (96, 64), (37, 53)]
TILE = 512  # pixels a warp's tile on the kernel's 16-byte path

_jax_luma = jax.jit(lambda x: jc.rgb_to_luma(jc.u8_to_f32(x)))


def _images(seed, h, w, b=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)


def _every_colour():
    v = np.arange(2 ** 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1)
    return rgb.astype(np.uint8).reshape(4096, 4096, 3)


def _luma_of(r, g, b):
    """The kernel's ``luma_of`` on u8 channel arrays: each channel times
    ``kInv255`` (an f32 product), then ``fma(b, .11, fma(g, .59, r * .30))``
    with each FMA rounded once."""
    inv = np.float32(tc._INV255)
    fr, fg, fb = (torch.from_numpy(c.astype(np.float32) * inv)
                  for c in (r, g, b))
    return tc._fma_f32(fb, tc._LUMA[2], tc._fma_f32(
        fg, tc._LUMA[1], fr * np.float32(tc._LUMA[0]))).numpy()


def _emulate(x):
    """The kernel's two paths over an image of any shape (..., 3): where it
    is one contiguous byte run, whole tiles of 512 pixels, each group of
    four pixels read from the tile as three little-endian 32-bit words
    with pixel p's bytes at 3p, 3p + 1 and 3p + 2 of the group's twelve;
    then the last npix % 512 pixels byte by byte."""
    flat = np.ascontiguousarray(x).reshape(-1)
    npix = flat.size // 3
    done = npix // TILE * TILE
    words = flat[:done * 3].view("<u4").reshape(done // 4, 3)
    out = np.empty(npix, np.float32)
    y = np.empty((done // 4, 4), np.float32)
    for p in range(4):
        ch = [(words[:, (3 * p + c) // 4] >> (8 * ((3 * p + c) % 4))) & 255
              for c in range(3)]
        y[:, p] = _luma_of(*ch)
    out[:done] = y.reshape(-1)
    tail = flat[done * 3:].reshape(-1, 3)
    out[done:] = _luma_of(tail[:, 0], tail[:, 1], tail[:, 2])
    return out.reshape(x.shape[:-1])


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_reference_bit_equal_to_jax(h, w):
    x = _images(h * w, h, w)
    j = np.asarray(_jax_luma(jnp.asarray(x)))
    t = k8.luma_u8_reference(torch.from_numpy(x))
    assert t.shape == (3, h, w) and t.dtype == torch.float32
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


def test_kernel_arithmetic_bit_equal_to_the_table_on_every_colour():
    # The vector path's unpacking and the kernel's chain, over one 4096 x
    # 4096 image that holds every colour (npix a multiple of 512), and the
    # byte path on the last 13 pixels of a run of 3 tiles and 13.
    rgb = _every_colour()
    want = k8.luma_u8_reference(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(_bits(_emulate(rgb)), _bits(want))
    tail = rgb.reshape(-1, 3)[-(TILE * 3 + 13):]
    np.testing.assert_array_equal(_bits(_emulate(tail)),
                                  _bits(want.reshape(-1)[-tail.shape[0]:]))


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_kernel_arithmetic_bit_equal_to_jax(h, w):
    x = _images(7 + h, h, w)
    np.testing.assert_array_equal(_bits(_emulate(x)),
                                  _bits(np.asarray(_jax_luma(jnp.asarray(x)))))


def test_kernel_constants_are_the_f32_values_jax_multiplies_by():
    # The source's constants as the compiler reads them: f32(1/255) as a
    # hex float literal, the luma row as f32 literals.
    src = SOURCE.read_text()
    inv = re.search(r"kInv255 = (0x[0-9a-fp.+-]+)f;", src).group(1)
    assert np.float32(float.fromhex(inv)) == np.float32(tc._INV255)
    chain = ("__fmaf_rn(fb, 0.11f, __fmaf_rn(fg, 0.59f, "
             "__fmul_rn(fr, 0.30f)))")
    assert chain in src
    for lit, want in (("0.11", tc._LUMA[2]), ("0.59", tc._LUMA[1]),
                      ("0.30", tc._LUMA[0])):
        assert np.float32(lit) == np.float32(want)


@pytest.mark.parametrize("view", ["contiguous", "strided", "single",
                                  "five_dims"])
def test_cpu_dispatch_takes_the_table_and_counts_no_launch(view):
    x = torch.from_numpy(_images(3, 37, 53))
    if view == "strided":
        x = x[:, ::2, 1::3]
    elif view == "single":
        x = x[1]
    elif view == "five_dims":
        x = x.reshape(3, 1, 37, 53, 3)
    before = k8.LAUNCHES
    want = k8.luma_u8_reference(x)
    for got in (k8.luma_u8(x), tc.luma_u8(x), tc.luma(x)):
        assert got.shape == x.shape[:-1]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert k8.LAUNCHES == before
    j = np.asarray(_jax_luma(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(_bits(want.numpy()), _bits(j))


@pytest.mark.parametrize("bad", ["float", "int32", "channels", "scalar",
                                 "device"])
def test_argument_checks_raise(bad):
    x = torch.from_numpy(_images(4, 8, 8))
    if bad == "float":
        x, err = x.float(), TypeError
    elif bad == "int32":
        x, err = x.int(), TypeError
    elif bad == "channels":
        x, err = x[..., :2], ValueError
    elif bad == "scalar":
        x, err = torch.tensor(7, dtype=torch.uint8), ValueError
    else:
        x, err = torch.empty((2, 8, 8, 3), dtype=torch.uint8,
                             device="meta"), ValueError
    with pytest.raises(err):
        k8.luma_u8(x)


def test_highest_embed_on_the_cpu_launches_nothing():
    # The HIGHEST path's two lumas go through colorspace.luma: on the CPU
    # its plain version, with no K8 (or K9) launch counted.
    rng = np.random.default_rng(9)
    rgb = torch.from_numpy(_images(9, 32, 48, b=2))
    marks = torch.from_numpy(rng.standard_normal((2, 1, 50)).astype(
        np.float32))
    before = launch_counts()
    tp.embed_verified(rgb, marks, WriteConfig(precision=Precision.HIGHEST))
    assert launch_counts() == before
