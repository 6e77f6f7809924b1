"""Integer images other than u8, and strided views, against the JAX package.

The JAX package scales every integer dtype by 1/255 (``pipeline._to_f32``)
wherever it reads an image as RGB in [0, 1]; its fast read's
``luma_diff`` takes non-u8 integers as floats, unscaled. The port follows
both. Same images and marks (numpy, seeded) through both packages, at the
three tiers, under each tier's tolerance from ``tests/test_torch_pipeline*``
and ``tests/test_torch_api.py``: u8 within one step, similarities within
0.01 sigma at HIGHEST and 0.1 at the fast tiers.

Strided views (a crop of a larger image, a transposed plane) run the same
entry points as the contiguous copy, bit for bit; on the card they are
made contiguous before the kernels (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
import spread_spectrum_watermarking_tpu as jw
from spread_spectrum_watermarking_torch import interop
from spread_spectrum_watermarking_torch.ops import dct
from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.models import pipeline as jp

N = 100
TIERS = ["highest", "high", "default"]
SIM_TOL = {"highest": 0.01, "high": 0.1, "default": 0.1}
DTYPES = [np.int32, np.int64]


def _inputs(seed=0, h=64, w=96):
    rng = np.random.default_rng(seed)
    rgb = np.stack([_pink_texture(rng, h, w) for _ in range(2)])
    marks = rng.standard_normal((2, 1, N)).astype(np.float32)
    return rgb, marks


def _configs(precision):
    jwc = jw.WriteConfig(precision=jw.Precision(precision))
    jrc = jw.ReadConfig(precision=jw.Precision(precision))
    return (jwc, jrc, interop.config_from_reference(jwc),
            interop.config_from_reference(jrc))


def _own_sims(ext, marks):
    ext = torch.from_numpy(np.array(ext))
    return torch.diagonal(tw.similarity(ext, torch.from_numpy(marks[:, 0])))


def _max_step(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
               .max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("precision", TIERS)
def test_embed_of_integer_images_matches_jax(precision, dtype):
    # Before the repair the port read int32/int64 as floats in [0, 1]: a
    # nearly white image, up to 254 u8 steps from the JAX package.
    rgb, marks = _inputs(1)
    x = rgb.astype(dtype)
    jwc, _, twc, _ = _configs(precision)
    jm = jp.embed(jnp.asarray(x), jnp.asarray(marks), jwc)
    tm = tw.embed(torch.from_numpy(x), torch.from_numpy(marks), twc)
    assert tm.dtype == torch.uint8 and tm.shape == rgb.shape
    assert _max_step(jm, tm.numpy()) <= 1
    # And within one step of the same image as u8 (the float epilogue).
    assert _max_step(tm.numpy(), tw.embed(torch.from_numpy(rgb),
                                          torch.from_numpy(marks), twc)) <= 1
    tf = tw.embed(torch.from_numpy(x), torch.from_numpy(marks), twc,
                  quantize=False)
    jf = jp.embed(jnp.asarray(x), jnp.asarray(marks), jwc, quantize=False)
    assert tf.dtype == torch.float32
    assert float(np.abs(np.asarray(jf) - tf.numpy()).max()) <= 1.0 / 255


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("precision", TIERS)
def test_embed_verified_and_extract_of_integer_images_match_jax(precision,
                                                                dtype):
    rgb, marks = _inputs(2)
    x = rgb.astype(dtype)
    jwc, jrc, twc, trc = _configs(precision)
    jm, je = jp.embed_verified(jnp.asarray(x), jnp.asarray(marks), jwc)
    tm, te = tw.embed_verified(torch.from_numpy(x), torch.from_numpy(marks),
                               twc)
    assert _max_step(jm, tm.numpy()) <= 1
    # A u8 output read against an integer base: the JAX package's fast read
    # mixes scales here, and the port with it.
    gap = (_own_sims(je, marks) - _own_sims(te.numpy(), marks)).abs()
    assert bool((gap <= SIM_TOL[precision]).all())
    # Base and derived both integer: a read that detects. Each package
    # reads its own marks: at HIGH the two rank near-ties differently.
    j_derived = jnp.asarray(np.asarray(jm).astype(dtype))
    j_ext = jp.extract(jnp.asarray(x), j_derived, N, jrc)
    t_ext = tw.extract(torch.from_numpy(x),
                       torch.from_numpy(tm.numpy().astype(dtype)), N, trc)
    t_own = _own_sims(t_ext.numpy(), marks)
    gap = (_own_sims(j_ext, marks) - t_own).abs()
    assert bool((gap <= SIM_TOL[precision]).all())
    assert bool((t_own > 6.0).all())


@pytest.mark.parametrize("precision", TIERS)
def test_writer_and_reader_take_integer_images(precision):
    rgb, marks = _inputs(3)
    img = rgb[0].astype(np.int32)
    mark = marks[0, 0]
    jwc, jrc, twc, trc = _configs(precision)
    jm = jw.Writer(img, jwc).mark(mark)
    tm = tw.Writer(img, twc, device="cpu").mark(mark)
    assert tm.dtype == np.uint8 and _max_step(jm, tm) <= 1
    t_ext = tw.Reader.base(img, trc, device="cpu").extract(
        tw.Reader.derived(tm.astype(np.int32), trc, device="cpu"), N)
    j_ext = jw.Reader.base(img, jrc).extract(
        jw.Reader.derived(np.asarray(jm).astype(np.int32), jrc), N)
    t_sim = tw.Tester(t_ext, device="cpu").similarity(mark)
    j_sim = jw.Tester(j_ext).similarity(mark)
    assert abs(t_sim.similarity - j_sim.similarity) <= SIM_TOL[precision]
    assert t_sim.exceeds_sigma(6.0)


def _crop(rgb):
    """A strided view: the inner part of a larger image."""
    big = np.pad(rgb, ((0, 0), (8, 8), (8, 8), (0, 0)), mode="reflect")
    return torch.from_numpy(big)[:, 8:-8, 8:-8]


@pytest.mark.parametrize("precision", TIERS)
def test_strided_views_run_as_their_contiguous_copies(precision):
    rgb, marks = _inputs(4)
    view = _crop(rgb)
    assert not view.is_contiguous()
    dense = view.contiguous()
    m = torch.from_numpy(marks)
    _, _, twc, trc = _configs(precision)
    vm, ve = tw.embed_verified(view, m, twc)
    dm, de = tw.embed_verified(dense, m, twc)
    assert torch.equal(vm, dm) and torch.equal(ve, de)
    assert torch.equal(tw.embed(view, m, twc), dm)
    derived_view = _crop(dm.numpy())
    assert torch.equal(tw.extract(view, derived_view, N, trc),
                       tw.extract(dense, dm, N, trc))
    if precision != "highest":
        idx, vals = tw.rank_base(view, N, trc)
        assert torch.equal(
            tw.extract_ranked(view, derived_view, idx, vals, trc),
            tw.extract_ranked(dense, dm, *tw.rank_base(dense, N, trc), trc))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("precision", TIERS)
def test_strided_planes_transform_as_their_contiguous_copies(precision, fold):
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, 96, 128), dtype=np.float32))
    p = tw.Precision(precision)
    for view in (x.transpose(-1, -2), x[:, 8:-8, 16:-16]):
        assert not view.is_contiguous()
        dense = view.contiguous()
        assert torch.equal(dct.dct2_2d(view, precision=p, fold=fold),
                           dct.dct2_2d(dense, precision=p, fold=fold))
        assert torch.equal(dct.idct2_2d(view, precision=p, fold=fold),
                           dct.idct2_2d(dense, precision=p, fold=fold))
