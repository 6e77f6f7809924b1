"""The port's HIGHEST tier as a whole, against the JAX package.

Same u8 images and marks (numpy, seeded) through both packages' pipelines
at the default configs (``Precision.HIGHEST``), held to ROADMAP's HIGHEST
standard: index recall >= 0.99 (the selection is exact in both, so only
near-ties of last-ulp differences in the planes can move it), u8 output
within one step, self-similarities within 0.01 sigma and above 6 sigma,
random marks below 4 sigma. Detection across the packages both ways,
including JAX's ``prepare_base`` cache read by the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_torch import interop
from spread_spectrum_watermarking_tpu import config as jcfg
from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.models import pipeline as jp

N = 200
GEOMETRIES = [(64, 96), (96, 64), (37, 59)]


def _inputs(h, w, seed=0):
    rng = np.random.default_rng(seed)
    rgb = np.stack([_pink_texture(rng, h, w) for _ in range(2)])
    marks = rng.standard_normal((2, 1, N)).astype(np.float32)
    return rgb, marks


def _sims(ext, marks):
    """(self-similarity per image, |random-mark similarity| max)."""
    ext = torch.from_numpy(np.array(ext, dtype=np.float32))
    own = torch.diagonal(tw.similarity(ext, torch.from_numpy(marks[:, 0])))
    rand = np.random.default_rng(99).standard_normal((8, N)).astype(np.float32)
    other = tw.similarity(ext, torch.from_numpy(rand))
    return own.numpy(), float(other.abs().max())


def _assert_detects_like(t_ext, j_ext, marks):
    t_own, t_rand = _sims(t_ext, marks)
    j_own, _ = _sims(j_ext, marks)
    assert np.all(np.abs(t_own - j_own) <= 0.01)
    assert np.all(t_own > 6.0) and t_rand < 4.0


def _recall(a, b):
    return min(len(np.intersect1d(x, y)) / N for x, y in zip(a, b))


def _step(a, b):
    return int(np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).max())


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_embed_verified_and_extract_match_jax(h, w):
    rgb, marks = _inputs(h, w)
    base_j, base_t = jnp.asarray(rgb), torch.from_numpy(rgb)
    jm, je = jp.embed_verified(base_j, jnp.asarray(marks))
    tm, te = tw.embed_verified(base_t, torch.from_numpy(marks))
    assert tm.dtype == torch.uint8 and tm.shape == base_t.shape
    assert _step(jm, tm) <= 1
    _assert_detects_like(te, je, marks)
    ji = np.asarray(jp.prepare_base(base_j, N)[1])
    ti = tw.prepare_base(base_t, N)[1].numpy()
    assert _recall(ji, ti) >= 0.99
    for sparse in (True, False):
        te2 = tw.extract(base_t, tm, N, sparse_derived=sparse)
        je2 = jp.extract(base_j, jm, N, sparse_derived=sparse)
        _assert_detects_like(te2, je2, marks)
        if sparse:  # the same computation as embed_verified's read
            torch.testing.assert_close(te2, te, rtol=0, atol=0)


@pytest.mark.parametrize("h,w", GEOMETRIES)
@pytest.mark.parametrize("sparse_idct", [True, False])
def test_embed_matches_jax(h, w, sparse_idct):
    rgb, marks = _inputs(h, w, seed=1)
    jm = jp.embed(jnp.asarray(rgb), jnp.asarray(marks), sparse_idct=sparse_idct)
    tm = tw.embed(torch.from_numpy(rgb), torch.from_numpy(marks),
                  sparse_idct=sparse_idct)
    assert _step(jm, tm) <= 1
    assert np.mean(np.asarray(jm) == tm.numpy()) >= 0.999
    assert np.any(tm.numpy() != rgb)
    ext = tw.extract(torch.from_numpy(rgb), tm, N)
    _assert_detects_like(ext, jp.extract(jnp.asarray(rgb), jm, N), marks)


def test_full_inverse_stays_within_a_step_of_the_sparse_one():
    rgb, marks = _inputs(64, 96, seed=2)
    base, m = torch.from_numpy(rgb), torch.from_numpy(marks)
    assert _step(tw.embed(base, m, sparse_idct=False), tw.embed(base, m)) <= 1


@pytest.mark.parametrize("sparse_idct", [True, False])
def test_float_input_and_output_match_jax(sparse_idct):
    rgb, marks = _inputs(37, 59, seed=3)
    rgbf = rgb.astype(np.float32) / np.float32(255.0)
    jf = np.asarray(jp.embed(jnp.asarray(rgbf), jnp.asarray(marks),
                             jcfg.WriteConfig(), False, sparse_idct))
    tf = tw.embed(torch.from_numpy(rgbf), torch.from_numpy(marks),
                  tw.WriteConfig(), False, sparse_idct)
    assert tf.dtype == torch.float32 and tf.shape == rgbf.shape
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-5)
    jq, je = jp.embed_verified(jnp.asarray(rgbf), jnp.asarray(marks),
                               jcfg.WriteConfig(), False)
    tq, te = tw.embed_verified(torch.from_numpy(rgbf),
                               torch.from_numpy(marks), tw.WriteConfig(), False)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    _assert_detects_like(te, je, marks)


@pytest.mark.parametrize("h,w", [(64, 96), (96, 64)])
def test_prepared_pair_matches_jax(h, w):
    rgb, marks = _inputs(h, w, seed=4)
    marked = np.array(jp.embed(jnp.asarray(rgb), jnp.asarray(marks)))
    jflat, jidx = jp.prepare_base(jnp.asarray(rgb), N)
    jd_flat = jp.prepare_derived(jnp.asarray(marked))
    je = jp.extract_prepared(jflat, jidx, jd_flat)
    tflat, tidx = tw.prepare_base(torch.from_numpy(rgb), N)
    td_flat = tw.prepare_derived(torch.from_numpy(marked))
    te = tw.extract_prepared(tflat, tidx, td_flat)
    assert tflat.shape == (2, h * w) and tflat.dtype == torch.float32
    scale = float(np.abs(np.asarray(jflat)).max())
    np.testing.assert_allclose(tflat.numpy(), np.asarray(jflat), rtol=0,
                               atol=1e-4 * scale)
    assert _recall(np.asarray(jidx), tidx.numpy()) >= 0.99
    _assert_detects_like(te, je, marks)
    # Single images, and the plane rank_plane shows at HIGHEST.
    flat1, idx1 = tw.prepare_base(torch.from_numpy(rgb[1]), N)
    torch.testing.assert_close(idx1, tidx[1], rtol=0, atol=0)
    torch.testing.assert_close(flat1, tflat[1], rtol=0, atol=0)
    plane = tw.rank_plane(torch.from_numpy(rgb))
    torch.testing.assert_close(plane.reshape(2, -1), tflat, rtol=0, atol=0)


@pytest.mark.parametrize("h,w", [(64, 96), (96, 64)])
def test_detection_across_packages(h, w):
    rgb, marks = _inputs(h, w, seed=5)
    base_j, base_t = jnp.asarray(rgb), torch.from_numpy(rgb)
    port_marked = tw.embed(base_t, torch.from_numpy(marks))
    jax_marked = np.array(jp.embed(base_j, jnp.asarray(marks)))

    # Port-marked images, read by the JAX package.
    own, rand = _sims(jp.extract(base_j, jnp.asarray(port_marked.numpy()), N),
                      marks)
    assert np.all(own > 6.0) and rand < 4.0
    # JAX-marked images, read by the port.
    own, rand = _sims(tw.extract(base_t, torch.from_numpy(jax_marked), N),
                      marks)
    assert np.all(own > 6.0) and rand < 4.0
    # The JAX Reader's cache (prepare_base), carried into the port.
    flat, idx = interop.base_state_from_numpy(
        *jp.prepare_base(base_j, N), "cpu")
    assert flat.dtype == torch.float32 and idx.dtype == torch.int64
    ext = tw.extract_prepared(flat, idx,
                              tw.prepare_derived(torch.from_numpy(jax_marked)))
    own, rand = _sims(ext, marks)
    assert np.all(own > 6.0) and rand < 4.0


@pytest.mark.parametrize("ordering", ["energy-orthogonal", "legacy"])
@pytest.mark.parametrize("method,alpha", [("option1", 2.0), ("option3", 0.1)])
def test_other_orderings_and_methods_match_jax(ordering, method, alpha):
    rgb, marks = _inputs(64, 96, seed=6)
    jw = jcfg.WriteConfig(
        insertion=jcfg.InsertExtract(alpha, jcfg.Method(method)),
        ordering=jcfg.Ordering(ordering))
    tcw = interop.config_from_reference(jw)
    jm, je = jp.embed_verified(jnp.asarray(rgb), jnp.asarray(marks), jw)
    tm, te = tw.embed_verified(torch.from_numpy(rgb), torch.from_numpy(marks),
                               tcw)
    assert _step(jm, tm) <= 1
    t_own, _ = _sims(te, marks)
    j_own, _ = _sims(je, marks)
    assert np.all(np.abs(t_own - j_own) <= 0.01)


def test_extract_raises_where_the_reference_panics():
    rgb, _ = _inputs(37, 59, seed=7)
    base = torch.from_numpy(rgb)
    with pytest.raises(ValueError, match="not equal"):
        tw.extract(base, base[:, :-1], N)
    with pytest.raises(ValueError, match="exceeds"):
        tw.extract(base, base, 37 * 59)
    for sparse in (True, False):
        out = tw.extract(base, base, 37 * 59 - 1, sparse_derived=sparse)
        assert out.shape == (2, 37 * 59 - 1)


def test_unported_options_raise_at_highest():
    # The custom callables run at HIGHEST, against JAX with the same
    # callables; embed_verified still refuses a custom insert, as in JAX.
    rgb, marks = _inputs(37, 59, seed=8)
    base, m = torch.from_numpy(rgb), torch.from_numpy(marks)
    jbase, jm_ = jnp.asarray(rgb), jnp.asarray(marks)
    metric = lambda i, v: v  # noqa: E731  (signed, as LEGACY)
    np.testing.assert_array_equal(
        tw.prepare_base(base, N, tw.ReadConfig(custom_ordering=metric))[1],
        np.asarray(jp.prepare_base(jbase, N, jcfg.ReadConfig(
            custom_ordering=metric))[1]))
    tmk = tw.embed(base, m, tw.WriteConfig(custom_ordering=metric))
    jmk = jp.embed(jbase, jm_, jcfg.WriteConfig(custom_ordering=metric))
    assert _step(jmk, tmk) <= 1
    _assert_detects_like(
        tw.extract(base, tmk, N, tw.ReadConfig(custom_ordering=metric)),
        jp.extract(jbase, jmk, N, jcfg.ReadConfig(custom_ordering=metric)),
        marks)
    ins = lambda i, o, k: o * (1.0 + 0.1 * k)  # noqa: E731  (Option2)
    tmk = tw.embed(base, m, tw.WriteConfig(custom_insert=ins))
    assert _step(jp.embed(jbase, jm_, jcfg.WriteConfig(custom_insert=ins)),
                 tmk) <= 1
    torch.testing.assert_close(tmk, tw.embed(base, m), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tw.embed_verified(base, m, tw.WriteConfig(custom_insert=ins))
    inv = lambda i, b, d: (d - b) / (b * 0.1)  # noqa: E731  (its inverse)
    for sparse in (True, False):
        _assert_detects_like(
            tw.extract(base, tmk, N, tw.ReadConfig(custom_extract=inv),
                       sparse_derived=sparse),
            jp.extract(jbase, jnp.asarray(tmk.numpy()), N,
                       jcfg.ReadConfig(custom_extract=inv),
                       sparse_derived=sparse), marks)
