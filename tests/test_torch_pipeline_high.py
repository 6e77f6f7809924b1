"""The port's HIGH tier as a whole, and the fast tiers' remaining branches
(float images, float output, the full inverse, the prepared pair), against
the JAX package.

Same images and marks (numpy, seeded) through both packages' pipelines.
Bounds, as for the DEFAULT tier (tests/test_torch_pipeline.py): index
recall >= 0.99 (the port selects exactly, JAX by ``approx_max_k``; and JAX
on the CPU computes HIGH's first pass in f32, where the port splits it into
bf16x3), u8 output within one step, self-similarities within 0.1 sigma and
above 6 sigma, random marks below 4 sigma; detection across the packages
both ways; and, inside the port, the detect path bit-equal to
``embed_verified``'s extraction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_torch import interop
from spread_spectrum_watermarking_torch.ops import colorspace as tc
from spread_spectrum_watermarking_torch.ops import dct as td
from spread_spectrum_watermarking_tpu import config as jcfg
from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.models import pipeline as jp

N = 200
GEOMETRIES = [(64, 96), (96, 64), (37, 59)]
FAST = ["default", "high"]


def _configs(precision="high"):
    jw = jcfg.WriteConfig(precision=jcfg.Precision(precision))
    jr = jcfg.ReadConfig(precision=jcfg.Precision(precision))
    return jw, jr, interop.config_from_reference(jw), \
        interop.config_from_reference(jr)


def _inputs(h, w, seed=0, b=2):
    rng = np.random.default_rng(seed)
    rgb = np.stack([_pink_texture(rng, h, w) for _ in range(b)])
    marks = rng.standard_normal((b, 1, N)).astype(np.float32)
    return rgb, marks


def _sims(ext, marks):
    """(self-similarity per image, |random-mark similarity| max)."""
    ext = torch.from_numpy(np.array(ext, dtype=np.float32))
    own = torch.diagonal(tw.similarity(ext, torch.from_numpy(marks[:, 0])))
    rand = np.random.default_rng(99).standard_normal((8, N)).astype(np.float32)
    other = tw.similarity(ext, torch.from_numpy(rand))
    return own.numpy(), float(other.abs().max())


def _recall(a, b):
    return min(len(np.intersect1d(x, y)) / x.shape[-1]
               for x, y in zip(np.asarray(a), np.asarray(b)))


def _agree(j_ext, t_ext, marks):
    j_own, _ = _sims(j_ext, marks)
    t_own, rand = _sims(t_ext, marks)
    assert np.all(np.abs(j_own - t_own) <= 0.1)
    assert np.all(t_own > 6.0) and rand < 4.0


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_embed_verified_matches_jax(h, w):
    rgb, marks = _inputs(h, w)
    jw, jr, tw_, tr = _configs()
    jm, je = jp.embed_verified(jnp.asarray(rgb), jnp.asarray(marks), jw)
    tm, te = tw.embed_verified(torch.from_numpy(rgb), torch.from_numpy(marks),
                               tw_)
    assert tm.dtype == torch.uint8 and tm.shape == rgb.shape
    ji, _ = jp.rank_base(jnp.asarray(rgb), N, jr)
    ti, _ = tw.rank_base(torch.from_numpy(rgb), N, tr)
    assert _recall(ji, ti.numpy()) >= 0.99
    assert np.abs(np.asarray(jm).astype(int) - tm.numpy().astype(int)).max() <= 1
    _agree(je, te, marks)


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_detect_path_bit_equal_to_embed_verified(h, w):
    rgb, marks = _inputs(h, w, seed=1)
    _, _, tw_, tr = _configs()
    base, m = torch.from_numpy(rgb), torch.from_numpy(marks)
    marked, ext = tw.embed_verified(base, m, tw_)
    torch.testing.assert_close(tw.embed(base, m, tw_), marked, rtol=0, atol=0)
    idx, vals = tw.rank_base(base, N, tr)
    torch.testing.assert_close(tw.extract_ranked(base, marked, idx, vals, tr),
                               ext, rtol=0, atol=0)
    torch.testing.assert_close(tw.extract(base, marked, N, tr), ext,
                               rtol=0, atol=0)
    # The full second pass in place of the gather-dot: the same sums in
    # another order, so the same marks to well under 0.01 sigma.
    full = tw.extract(base, marked, N, tr, sparse_derived=False)
    own = [torch.diagonal(tw.similarity(e, m[:, 0])) for e in (ext, full)]
    assert bool(((own[0] - own[1]).abs() <= 0.01).all())


@pytest.mark.parametrize("sparse_derived", [True, False])
def test_extract_matches_jax(sparse_derived):
    # Each package reads the image its own embed marked. The mark is
    # positional (element k at the k-th ranked index), and the two planes
    # differ in their last bits (bf16x3 here, f32 in JAX on the CPU), so
    # near-ties on the bf16 rank plane swap places across the packages
    # (3% of the order on this input): a reader that ranks in the other
    # package's order loses about 0.2 sigma. Cross-package reads are held
    # to 6 sigma in test_detection_across_packages.
    rgb, marks = _inputs(64, 96, seed=2)
    jw, jr, tw_, tr = _configs()
    base, m = torch.from_numpy(rgb), torch.from_numpy(marks)
    t = tw.extract(base, tw.embed(base, m, tw_), N, tr,
                   sparse_derived=sparse_derived)
    jbase = jnp.asarray(rgb)
    j = jp.extract(jbase, jp.embed(jbase, jnp.asarray(marks), jw), N, jr,
                   sparse_derived=sparse_derived)
    _agree(j, t, marks)


def test_rank_plane_and_single_image_match_jax():
    rgb, marks = _inputs(64, 96, seed=3)
    _, jr, tw_, tr = _configs()
    p = tw.Precision.HIGH
    t = tw.rank_plane(torch.from_numpy(rgb), p)
    j = np.asarray(jp.rank_plane(jnp.asarray(rgb), jcfg.Precision.HIGH))
    assert t.shape == rgb.shape[:3] and t.dtype == torch.float32
    # The bf16 plane; first-pass roundings that flip move it by an ulp.
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=2 ** -6 * np.abs(j).max())
    base = torch.from_numpy(rgb)
    shared = torch.from_numpy(marks[0, 0])
    batch_marked, batch_ext = tw.embed_verified(base, shared, tw_)
    marked, ext = tw.embed_verified(base[1], shared, tw_)
    torch.testing.assert_close(marked, batch_marked[1], rtol=0, atol=0)
    torch.testing.assert_close(ext, batch_ext[1], rtol=0, atol=0)
    torch.testing.assert_close(tw.rank_plane(base[1], p), t[1], rtol=0, atol=0)


@pytest.mark.parametrize("h,w", [(64, 96), (96, 64)])
def test_detection_across_packages(h, w):
    rgb, marks = _inputs(h, w, seed=4)
    jw, jr, tw_, tr = _configs()
    base_j, base_t = jnp.asarray(rgb), torch.from_numpy(rgb)
    port_marked = tw.embed(base_t, torch.from_numpy(marks), tw_)
    jax_marked = jp.embed(base_j, jnp.asarray(marks), jw)

    # Port-marked images, read by the JAX package.
    ji, jv = jp.rank_base(base_j, N, jr)
    ext = jp.extract_ranked(base_j, jnp.asarray(port_marked.numpy()), ji, jv,
                            jr)
    own, rand = _sims(ext, marks)
    assert np.all(own > 6.0) and rand < 4.0

    # JAX-marked images, read by the port from the JAX Reader's cache.
    idx, vals = interop.rank_state_from_numpy(ji, jv, "cpu")
    ext = tw.extract_ranked(base_t, torch.from_numpy(np.asarray(jax_marked)),
                            idx, vals, tr)
    own, rand = _sims(ext, marks)
    assert np.all(own > 6.0) and rand < 4.0


@pytest.mark.parametrize("precision", FAST)
def test_float_input_matches_jax(precision):
    rgb, marks = _inputs(64, 96, seed=5)
    rgbf = rgb.astype(np.float32) / 255.0
    jw, jr, tw_, tr = _configs(precision)
    jm, je = jp.embed_verified(jnp.asarray(rgbf), jnp.asarray(marks), jw)
    tm, te = tw.embed_verified(torch.from_numpy(rgbf),
                               torch.from_numpy(marks), tw_)
    assert tm.dtype == torch.uint8
    ji, _ = jp.rank_base(jnp.asarray(rgbf), N, jr)
    ti, _ = tw.rank_base(torch.from_numpy(rgbf), N, tr)
    assert _recall(ji, ti.numpy()) >= 0.99
    assert np.abs(np.asarray(jm).astype(int) - tm.numpy().astype(int)).max() <= 1
    _agree(je, te, marks)
    # The float route is the u8 route's numerics: same plane, same marks.
    tu, _ = tw.embed_verified(torch.from_numpy(rgb), torch.from_numpy(marks),
                              tw_)
    assert int((tu.int() - tm.int()).abs().max()) <= 1


@pytest.mark.parametrize("precision", FAST)
def test_float_output_matches_jax(precision):
    rgb, marks = _inputs(64, 96, seed=6)
    jw, jr, tw_, tr = _configs(precision)
    base, m = torch.from_numpy(rgb), torch.from_numpy(marks)
    t = tw.embed(base, m, tw_, quantize=False)
    j = np.asarray(jp.embed(jnp.asarray(rgb), jnp.asarray(marks), jw,
                            quantize=False))
    assert t.dtype == torch.float32 and t.shape == rgb.shape
    # The bf16 dY of the two differs by a few of its ulps where their sums
    # run in another order: far under one u8 step.
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=0.25 / 255)
    tm, te = tw.embed_verified(base, m, tw_, quantize=False)
    torch.testing.assert_close(tm, t, rtol=0, atol=0)
    jm, je = jp.embed_verified(jnp.asarray(rgb), jnp.asarray(marks), jw,
                               quantize=False)
    _agree(je, te, marks)
    # Quantized, the float output is the u8 output.
    torch.testing.assert_close(tc.f32_to_u8(t), tw.embed(base, m, tw_),
                               rtol=0, atol=1)


@pytest.mark.parametrize("precision", FAST)
@pytest.mark.parametrize("h,w", [(64, 96), (37, 59)])
def test_full_inverse_is_read_by_the_fast_reader(precision, h, w):
    # JAX pipeline.py:370-383: sparse_idct=False at a fast tier ranks
    # through the fast prologue, so the fast Reader finds the mark.
    rgb, marks = _inputs(h, w, seed=7)
    jw, jr, tw_, tr = _configs(precision)
    base, m = torch.from_numpy(rgb), torch.from_numpy(marks)
    t = tw.embed(base, m, tw_, sparse_idct=False)
    assert t.dtype == torch.uint8 and t.shape == rgb.shape
    idx, vals = tw.rank_base(base, N, tr)
    own, rand = _sims(tw.extract_ranked(base, t, idx, vals, tr), marks)
    assert np.all(own > 6.0) and rand < 4.0
    # Against JAX: JAX on the CPU runs the full transforms in f32, so at
    # HIGH (bf16x3, about 2^-14 of the terms per pass) the images agree
    # within one u8 step; at DEFAULT the port's bf16 round trip of the
    # whole plane adds up to 2^-5 of |D| |C Y C^T| |D|^T per pixel (the
    # bound of tests/test_torch_dct_high.py, twice), a few u8 steps.
    j = np.asarray(jp.embed(jnp.asarray(rgb), jnp.asarray(marks), jw,
                            sparse_idct=False)).astype(int)
    step = np.abs(t.numpy().astype(int) - j)
    if precision == "high":
        assert step.max() <= 1
    else:
        assert step.max() <= 6 and np.mean(step <= 1) >= 0.95
    t_float = tw.embed(base, m, tw_, quantize=False, sparse_idct=False)
    torch.testing.assert_close(tc.f32_to_u8(t_float), t, rtol=0, atol=0)


@pytest.mark.parametrize("precision", FAST)
def test_prepared_pair_matches_jax(precision):
    rgb, _ = _inputs(64, 96, seed=8)
    jw, jr, tw_, tr = _configs(precision)
    flat, idx = tw.prepare_base(torch.from_numpy(rgb), N, tr)
    jflat, jidx = jp.prepare_base(jnp.asarray(rgb), N, jr)
    assert flat.shape == (2, 64 * 96) and idx.shape == (2, N)
    y = tc.luma(torch.from_numpy(rgb)).double().numpy()
    a = np.abs(td.dct2_basis(64).astype(np.float64)) @ np.abs(y) @ \
        np.abs(td.dct2_basis(96).astype(np.float64)).T
    factor = 2.0 ** -12 if precision == "high" else 2.0 ** -5
    assert np.all(np.abs(flat.numpy() - np.asarray(jflat))
                  <= factor * a.reshape(2, -1) + 1e-3)
    # Exact selection on both sides; at DEFAULT the port's plane carries
    # bf16 rounding that JAX's CPU plane does not, which moves near ties.
    assert _recall(jidx, idx.numpy()) >= (0.99 if precision == "high"
                                          else 0.9)
    dflat = tw.prepare_derived(torch.from_numpy(rgb), tr)
    torch.testing.assert_close(dflat, flat, rtol=0, atol=0)
    zeros = tw.extract_prepared(flat, idx, dflat, tr)
    assert bool((zeros == 0).all())


def test_high_paired_with_highest_over_8_seeds():
    # tests/test_precision_gate.py's paired gate, on 1/f textures: per seed
    # HIGH tracks HIGHEST within 0.25 sigma and 0.08 of mean |error|, with
    # no drift in the means.
    s = 8
    rng = np.random.default_rng(123)
    rgb = np.stack([_pink_texture(rng, 96, 128) for _ in range(s)])
    marks = rng.standard_normal((s, N)).astype(np.float32)
    base, m = torch.from_numpy(rgb), torch.from_numpy(marks[:, None, :])

    def run(p):
        marked = tw.embed(base, m, tw.WriteConfig(precision=p))
        ext = tw.extract(base, marked, N, tw.ReadConfig(precision=p)).numpy()
        sims = np.einsum("sn,sn->s", ext, marks) / np.sqrt(
            np.einsum("sn,sn->s", ext, ext))
        return sims, np.abs(ext - marks).mean(axis=1)

    sims_f, errs_f = run(tw.Precision.HIGH)
    sims_x, errs_x = run(tw.Precision.HIGHEST)
    dsim, derr = sims_f - sims_x, errs_f - errs_x
    assert np.abs(dsim).max() < 0.25, dsim
    assert dsim.mean() > -0.05, dsim
    assert np.abs(derr).max() < 0.08, derr
    assert derr.mean() < 0.008, derr
    assert np.all(sims_f > 6.0)
