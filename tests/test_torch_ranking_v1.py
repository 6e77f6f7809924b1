"""Rank generation 1 of the port against the JAX package.

Selection: on the same bf16 plane (JAX's own, jitted), the port's exact
top-n with its tie rule (key desc, index asc) against JAX's
``approx_max_k``, whose choice among equal keys at the boundary is
unspecified. Pinned, as tests/test_torch_ranking.py pins generation 2:
equal multisets of selected bf16 keys, index recall >= 0.99, values bit
for bit where the indices agree, and the port's own (f32 metric desc,
index asc) order with DC last. The slice: ``embed``, ``embed_verified``,
``rank_base`` and ``extract_ranked`` at ``rank_version=1``, DEFAULT and
HIGH, held as the generation-2 pipelines are (u8 within one step,
self-similarities within 0.1 sigma of JAX's and above 6 sigma, random
marks below 4 sigma), detection across the packages both ways, and
Writer/Reader bit for bit inside the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_torch import interop
from spread_spectrum_watermarking_torch.config import Ordering
from spread_spectrum_watermarking_torch.ops import ranking as tr
from spread_spectrum_watermarking_tpu import config as jcfg
from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.models import pipeline as jp
from spread_spectrum_watermarking_tpu.ops import ranking as jr

N = 200
GEOMETRIES = [(64, 96), (96, 64), (37, 59)]
ORDERINGS = ["energy", "energy-orthogonal", "legacy"]
FAST = ["default", "high"]
_jax_select = jax.jit(jr.approx_top_indices,
                      static_argnames=("n", "ordering", "custom_metric",
                                       "version"))


def _plane(h, w, precision):
    rng = np.random.default_rng(h * 1000 + w)
    rgb = jnp.asarray(np.stack([_pink_texture(rng, h, w) for _ in range(2)]))
    ax = -2 if h <= w else -1
    return jp._second_pass(jp._half_pass(rgb, jcfg.Precision(precision), ax),
                           ax)


def _bf16_keys(plane_f32, idx, ordering):
    """Generation 1's selection key (the bf16 metric) at ``idx``, jitted."""
    m = jax.jit(jr.ranking_metric, static_argnums=1)(
        jnp.asarray(plane_f32, jnp.bfloat16), jcfg.Ordering(ordering))
    flat = np.asarray(m.astype(jnp.bfloat16).astype(jnp.float32)).reshape(
        plane_f32.shape[0], -1)
    return np.take_along_axis(flat, idx, axis=-1)


@pytest.mark.parametrize("h,w", GEOMETRIES)
@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("precision", FAST)
def test_selection_agrees_with_jax(h, w, ordering, precision):
    plane = _plane(h, w, precision)
    ji, jv = (np.asarray(a) for a in _jax_select(
        plane, n=N, ordering=jcfg.Ordering(ordering), version=1))
    pf = np.array(plane.astype(jnp.float32))
    ti, tv = (a.numpy() for a in tr.approx_top_indices(
        torch.from_numpy(pf).to(torch.bfloat16), N, Ordering(ordering),
        version=1))
    assert ti.dtype == np.int64 and not np.any(ti == 0)
    jk, tk = _bf16_keys(pf, ji, ordering), _bf16_keys(pf, ti, ordering)
    for b in range(2):
        assert sorted(jk[b]) == sorted(tk[b])
        common = np.intersect1d(ji[b], ti[b])
        assert len(common) / N >= 0.99
        jmap = dict(zip(ji[b].tolist(), jv[b].tolist()))
        tmap = dict(zip(ti[b].tolist(), tv[b].tolist()))
        assert all(jmap[i] == tmap[i] for i in common.tolist())
        # The values are the plane's, and the order (f32 metric desc, index
        # asc), the metric recomputed from them as JAX does.
        np.testing.assert_array_equal(tv[b], pf.reshape(2, -1)[b][ti[b]])
        metric = np.asarray(jr._metric_from_values(
            jnp.asarray(tv[b]), jnp.asarray(ti[b], jnp.int32), h, w,
            jcfg.Ordering(ordering), h * w))
        pairs = list(zip((-metric).tolist(), ti[b].tolist()))
        assert pairs == sorted(pairs)


def test_dc_last_and_ties_toward_lower_index():
    plane = torch.ones((1, 8, 8), dtype=torch.bfloat16)
    plane[0, 0, 0] = 100.0
    idx, vals = tr.approx_top_indices(plane, 5, Ordering.ENERGY, version=1)
    assert idx.tolist() == [[1, 2, 3, 4, 5]] and vals.tolist() == [[1.0] * 5]
    idx, vals = tr.approx_top_indices(plane, 64, Ordering.ENERGY, version=1)
    assert idx[0, -1].item() == 0 and vals[0, -1].item() == 100.0


@pytest.mark.parametrize("version", [0, 3])
def test_unknown_generations_raise_in_both_packages(version):
    plane = np.ones((1, 4, 4), np.float32)
    with pytest.raises(ValueError, match="rank_version") as j:
        jr.approx_top_indices(jnp.asarray(plane, jnp.bfloat16), 2,
                              jcfg.Ordering.ENERGY, version=version)
    with pytest.raises(ValueError, match="rank_version") as t:
        tr.approx_top_indices(torch.from_numpy(plane).to(torch.bfloat16), 2,
                              Ordering.ENERGY, version=version)
    assert str(t.value) == str(j.value)
    rgb = torch.zeros((1, 16, 16, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="rank_version"):
        tw.embed(rgb, torch.zeros(1, 4), tw.WriteConfig(
            precision=tw.Precision.DEFAULT, rank_version=version))


def _configs(precision):
    jw = jcfg.WriteConfig(precision=jcfg.Precision(precision), rank_version=1)
    jrc = jcfg.ReadConfig(precision=jcfg.Precision(precision), rank_version=1)
    return jw, jrc, interop.config_from_reference(jw), \
        interop.config_from_reference(jrc)


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
    return own.numpy(), float(tw.similarity(
        ext, torch.from_numpy(rand)).abs().max())


def _recall(a, b):
    return min(len(np.intersect1d(x, y)) / N
               for x, y in zip(np.asarray(a), np.asarray(b)))


@pytest.mark.parametrize("h,w", GEOMETRIES)
@pytest.mark.parametrize("precision", FAST)
def test_embed_verified_matches_jax(h, w, precision):
    rgb, marks = _inputs(h, w)
    jw, jrc, tcw, tcr = _configs(precision)
    jm, je = jp.embed_verified(jnp.asarray(rgb), jnp.asarray(marks), jw)
    tm, te = tw.embed_verified(torch.from_numpy(rgb), torch.from_numpy(marks),
                               tcw)
    ji, _ = jp.rank_base(jnp.asarray(rgb), N, jrc)
    ti, _ = tw.rank_base(torch.from_numpy(rgb), N, tcr)
    assert _recall(ji, ti.numpy()) >= 0.99
    assert np.abs(np.asarray(jm).astype(int) - tm.numpy().astype(int)).max() <= 1
    j_own, _ = _sims(je, marks)
    t_own, rand = _sims(te, marks)
    assert np.all(np.abs(j_own - t_own) <= 0.1)
    assert np.all(t_own > 6.0) and rand < 4.0


@pytest.mark.parametrize("precision", FAST)
def test_generations_rank_differently(precision):
    # Generation 1 is its own stored format: on the same base it selects
    # another set than generation 2, as in the JAX package.
    rgb, _ = _inputs(64, 96, seed=3)
    base = torch.from_numpy(rgb)
    v1 = tw.rank_base(base, N, _configs(precision)[3])[0].numpy()
    v2 = tw.rank_base(base, N, tw.ReadConfig(
        precision=tw.Precision(precision)))[0].numpy()
    assert not np.array_equal(v1, v2)


@pytest.mark.parametrize("h,w", [(64, 96), (96, 64)])
@pytest.mark.parametrize("precision", FAST)
def test_detection_across_packages(h, w, precision):
    rgb, marks = _inputs(h, w, seed=1)
    jw, jrc, tcw, tcr = _configs(precision)
    base_j, base_t = jnp.asarray(rgb), torch.from_numpy(rgb)
    port_marked = tw.embed(base_t, torch.from_numpy(marks), tcw)
    jax_marked = jp.embed(base_j, jnp.asarray(marks), jw)

    ji, jv = jp.rank_base(base_j, N, jrc)
    ext = jp.extract_ranked(base_j, jnp.asarray(port_marked.numpy()), ji, jv,
                            jrc)
    own, rand = _sims(ext, marks)
    assert np.all(own > 6.0) and rand < 4.0

    ext = tw.extract(base_t, torch.from_numpy(np.asarray(jax_marked)), N, tcr)
    own, rand = _sims(ext, marks)
    assert np.all(own > 6.0) and rand < 4.0


@pytest.mark.parametrize("h,w", GEOMETRIES)
@pytest.mark.parametrize("precision", FAST)
def test_writer_and_reader_agree_bit_for_bit(h, w, precision):
    rgb, marks = _inputs(h, w, seed=2)
    _, _, tcw, tcr = _configs(precision)
    base, m = torch.from_numpy(rgb), torch.from_numpy(marks)
    marked, ext = tw.embed_verified(base, m, tcw)
    torch.testing.assert_close(tw.embed(base, m, tcw), marked, rtol=0, atol=0)
    idx, vals = tw.rank_base(base, N, tcr)
    torch.testing.assert_close(tw.extract_ranked(base, marked, idx, vals, tcr),
                               ext, rtol=0, atol=0)
    torch.testing.assert_close(tw.extract(base, marked, N, tcr), ext,
                               rtol=0, atol=0)
    img, mark = rgb[0], marks[0, 0]
    out = tw.Writer(img, tcw, device="cpu").mark(mark)
    np.testing.assert_array_equal(out, marked[0].numpy())
    got = tw.Reader.base(img, tcr, device="cpu").extract(
        tw.Reader.derived(out, tcr, device="cpu"), N)
    np.testing.assert_array_equal(got, ext[0].numpy())
