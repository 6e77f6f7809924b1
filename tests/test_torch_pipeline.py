"""The port's fast-tier slice as a whole, against the JAX package.

Same u8 images and marks (numpy, seeded) through both packages' pipelines:
agreement of ranks, pixels and similarities; detection across packages in
both directions; and bit-exact Writer/Reader agreement inside the port.
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
JW = jcfg.WriteConfig(precision=jcfg.Precision.DEFAULT)
JR = jcfg.ReadConfig(precision=jcfg.Precision.DEFAULT)
TW = interop.config_from_reference(JW)
TR = interop.config_from_reference(JR)
GEOMETRIES = [(64, 96), (96, 64), (37, 59)]


def _inputs(h, w, seed=0):
    rng = np.random.default_rng(seed)
    rgb = np.stack([_pink_texture(rng, h, w) for _ in range(2)])
    marks = rng.standard_normal((2, 1, N)).astype(np.float32)
    return rgb, marks


def _sims(ext, marks):
    """(self-similarity per image, |random-mark similarity| max)."""
    ext = torch.as_tensor(np.asarray(ext))
    own = torch.diagonal(tw.similarity(ext, torch.from_numpy(marks[:, 0])))
    rand = np.random.default_rng(99).standard_normal((8, N)).astype(np.float32)
    other = tw.similarity(ext, torch.from_numpy(rand))
    return own.numpy(), float(other.abs().max())


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_embed_verified_matches_jax(h, w):
    rgb, marks = _inputs(h, w)
    jm, je = jp.embed_verified(jnp.asarray(rgb), jnp.asarray(marks), JW)
    tm, te = tw.embed_verified(torch.from_numpy(rgb), torch.from_numpy(marks),
                               TW)
    ji, _ = jp.rank_base(jnp.asarray(rgb), N, JR)
    ti, _ = tw.rank_base(torch.from_numpy(rgb), N, TR)
    for a, b in zip(np.asarray(ji), ti.numpy()):
        assert len(np.intersect1d(a, b)) / N >= 0.99
    step = np.abs(np.asarray(jm).astype(int) - tm.numpy().astype(int))
    assert step.max() <= 1
    j_own, _ = _sims(je, marks)
    t_own, _ = _sims(te, marks)
    assert np.all(np.abs(j_own - t_own) <= 0.1)
    assert np.all(t_own > 6.0)


@pytest.mark.parametrize("h,w", [(64, 96), (96, 64)])
def test_detection_across_packages(h, w):
    rgb, marks = _inputs(h, w, seed=1)
    base_j, base_t = jnp.asarray(rgb), torch.from_numpy(rgb)
    port_marked = tw.embed(base_t, torch.from_numpy(marks), TW)
    jax_marked = jp.embed(base_j, jnp.asarray(marks), JW)

    # Port-marked images, read by the JAX package.
    ji, jv = jp.rank_base(base_j, N, JR)
    ext = jp.extract_ranked(base_j, jnp.asarray(port_marked.numpy()), ji, jv,
                            JR)
    own, rand = _sims(ext, marks)
    assert np.all(own > 6.0) and rand < 4.0

    # JAX-marked images, read by the port from the JAX Reader's cache.
    idx, vals = interop.rank_state_from_numpy(ji, jv, "cpu")
    ext = tw.extract_ranked(base_t, torch.from_numpy(np.asarray(jax_marked)),
                            idx, vals, TR)
    own, rand = _sims(ext, marks)
    assert np.all(own > 6.0) and rand < 4.0


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_writer_and_reader_agree_bit_for_bit(h, w):
    rgb, marks = _inputs(h, w, seed=2)
    base = torch.from_numpy(rgb)
    marked, ext = tw.embed_verified(base, torch.from_numpy(marks), TW)
    torch.testing.assert_close(tw.embed(base, torch.from_numpy(marks), TW),
                               marked, rtol=0, atol=0)
    idx, vals = tw.rank_base(base, N, TR)
    torch.testing.assert_close(tw.extract_ranked(base, marked, idx, vals, TR),
                               ext, rtol=0, atol=0)
    plane = tw.rank_plane(base, tw.Precision.DEFAULT)
    assert plane.shape == (2, h, w) and plane.dtype == torch.float32


def test_single_image_and_shared_marks():
    rgb, marks = _inputs(37, 59, seed=3)
    base = torch.from_numpy(rgb)
    shared = torch.from_numpy(marks[0, 0])
    batch_marked, batch_ext = tw.embed_verified(base, shared, TW)
    marked, ext = tw.embed_verified(base[1], shared, TW)
    torch.testing.assert_close(marked, batch_marked[1], rtol=0, atol=0)
    torch.testing.assert_close(ext, batch_ext[1], rtol=0, atol=0)
    idx, vals = tw.rank_base(base[1], N, TR)
    torch.testing.assert_close(tw.extract_ranked(base[1], marked, idx, vals,
                                                 TR), ext, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["option1", "option3"])
def test_other_methods_round_trip(method):
    rgb, marks = _inputs(64, 96, seed=4)
    alpha = 2.0 if method == "option1" else 0.1
    cfg = tw.WriteConfig(insertion=tw.InsertExtract(alpha, tw.Method(method)),
                         precision=tw.Precision.DEFAULT)
    _, ext = tw.embed_verified(torch.from_numpy(rgb), torch.from_numpy(marks),
                               cfg)
    own, rand = _sims(ext, marks)
    assert np.all(own > 6.0) and rand < 4.0


def test_unported_tiers_and_options_raise():
    # Every tier and option of the JAX pipelines is ported; this held the
    # last ones, custom callables and rank generation 1, to raising. Now
    # each runs at both fast tiers, against JAX with the same callables.
    rgb, marks = _inputs(37, 59)
    base, m = torch.from_numpy(rgb), torch.from_numpy(marks)
    jbase, jm_ = jnp.asarray(rgb), jnp.asarray(marks)
    for p in ("default", "high"):
        jpr, tp = jcfg.Precision(p), tw.Precision(p)
        # A signed metric (LEGACY-like) as the custom ordering.
        jw = jcfg.WriteConfig(precision=jpr, custom_ordering=lambda i, v: v)
        tcw = tw.WriteConfig(precision=tp, custom_ordering=lambda i, v: v)
        _, je = jp.embed_verified(jbase, jm_, jw)
        _, te = tw.embed_verified(base, m, tcw)
        j_own, _ = _sims(je, marks)
        t_own, rand = _sims(te, marks)
        assert np.all(np.abs(j_own - t_own) <= 0.1)
        assert np.all(t_own > 6.0) and rand < 4.0
        # A custom insert that changes nothing leaves the u8 image as is.
        out = tw.embed(base, m, tw.WriteConfig(
            precision=tp, custom_insert=lambda i, o, k: o))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jp.embed(
            jbase, jm_, jcfg.WriteConfig(precision=jpr,
                                         custom_insert=lambda i, o, k: o))))
        np.testing.assert_array_equal(out.numpy(), rgb)
        # Rank generation 1: the reader cache, embed and embed_verified.
        jw1 = jcfg.WriteConfig(precision=jpr, rank_version=1)
        jr1 = jcfg.ReadConfig(precision=jpr, rank_version=1)
        tw1, tr1 = (interop.config_from_reference(c) for c in (jw1, jr1))
        ji, _ = jp.rank_base(jbase, N, jr1)
        ti, _ = tw.rank_base(base, N, tr1)
        assert all(len(np.intersect1d(a, b)) / N >= 0.99
                   for a, b in zip(np.asarray(ji), ti.numpy()))
        marked = tw.embed(base, m, tw1)
        tm, te = tw.embed_verified(base, m, tw1)
        torch.testing.assert_close(marked, tm, rtol=0, atol=0)
        _, je = jp.embed_verified(jbase, jm_, jw1)
        assert np.all(np.abs(_sims(je, marks)[0] - _sims(te, marks)[0]) <= 0.1)
        # A custom extract: the Option2 inverse written out, on both.
        inv = lambda i, b, d: (d - b) / (b * 0.1)  # noqa: E731
        je = jp.extract(jbase, jnp.asarray(tm.numpy()), N, jcfg.ReadConfig(
            precision=jpr, rank_version=1, custom_extract=inv))
        te = tw.extract(base, tm, N, tw.ReadConfig(
            precision=tp, rank_version=1, custom_extract=inv))
        j_own, _ = _sims(je, marks)
        t_own, rand = _sims(te, marks)
        assert np.all(np.abs(j_own - t_own) <= 0.1)
        assert np.all(t_own > 6.0) and rand < 4.0


def test_interop_maps_configs_and_state():
    jcfg_w = jcfg.WriteConfig(
        insertion=jcfg.InsertExtract(0.25, jcfg.Method.OPTION3),
        ordering=jcfg.Ordering.LEGACY, precision=jcfg.Precision.DEFAULT)
    cfg = interop.config_from_reference(jcfg_w)
    assert cfg == tw.WriteConfig(
        insertion=tw.InsertExtract(0.25, tw.Method.OPTION3),
        ordering=tw.Ordering.LEGACY, precision=tw.Precision.DEFAULT)
    rcfg = interop.config_from_reference(jcfg.ReadConfig())
    assert rcfg == tw.ReadConfig()
    with pytest.raises(ValueError):
        interop.config_from_reference(
            jcfg.ReadConfig(custom_extract=lambda i, b, d: d))
    idx, vals = interop.rank_state_from_numpy(
        np.arange(4, dtype=np.int32), np.ones(4, np.float32), "cpu")
    assert idx.dtype == torch.int64 and vals.dtype == torch.float32
    marks = interop.marks_from_numpy(np.zeros((2, 3)), "cpu")
    assert marks.dtype == torch.float32 and marks.shape == (2, 3)


def test_generate_normal_is_seeded_and_shaped():
    gen = torch.Generator().manual_seed(7)
    a = tw.generate_normal(gen, 1000, count=3)
    b = tw.generate_normal(torch.Generator().manual_seed(7), 1000, count=3)
    assert a.shape == (3, 1000) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert abs(float(a.std()) - 1.0) < 0.05
    assert tw.generate_normal(gen, 10).shape == (10,)
    assert tw.as_marks([1.0, 2.0]).shape == (1, 2)
