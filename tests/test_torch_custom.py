"""Custom insert, extract and ordering callables, each written once for the
JAX package and once in torch, at all three tiers, against JAX.

The callables depend on the flat index, so a package that passes the
wrong indices fails. Bounds: u8 output within one step of JAX's; index
recall >= 0.99 (the fast tiers select exactly in the port, by
``approx_max_k`` in JAX) and equal indices on the same f32 plane at
HIGHEST; the u8 bound holds where the two rank in the same order (at HIGH,
where JAX on the CPU computes the first pass in f32 and the port in
bf16x3, near-ties can swap places, and a swapped pair moves pixels
across the image: ROADMAP.md, Queue 3's last note), the similarity bounds
everywhere: similarities within 0.1 sigma of JAX's at the fast tiers and 0.01
at HIGHEST, above 6 sigma, random marks below 4 sigma. A callable that
reimplements a built-in is held to the built-in: Option2 as
``custom_insert`` bit for bit; its inverse as ``custom_extract`` within
1e-3 sigma (at the fast tiers it sees ``base + delta`` where the built-in
divides the delta itself); the ENERGY metric as ``custom_ordering``, the
same indices at HIGHEST and, at the fast tiers, where it selects on plain
bf16 keys and generation 2 on sign-in-LSB keys, a share of common
indices of at least 0.95 (0.995 at the least on this test's input). The
same share bounds the card's run of the same comparison (``chip_smoke.py``,
its ``custom`` phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_torch.ops import modulation as tm
from spread_spectrum_watermarking_torch.ops import ranking as tr
from spread_spectrum_watermarking_tpu import config as jcfg
from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.models import pipeline as jp
from spread_spectrum_watermarking_tpu.ops import modulation as jm
from spread_spectrum_watermarking_tpu.ops import ranking as jr

N = 200
A = 0.1
TIERS = ["default", "high", "highest"]
GEOMETRIES = [(64, 96), (37, 59)]


# The same callables in both packages: JAX first, then torch.
def j_insert(idx, o, w):
    return o * (1.0 + A * w * (1 + idx % 2))


def t_insert(idx, o, w):
    return o * (1.0 + A * w * (1 + idx % 2))


def j_extract(idx, b, d):
    return (d - b) / (b * A * (1 + idx % 2))


def t_extract(idx, b, d):
    return (d - b) / (b * A * (1 + idx % 2))


def j_metric(pos, v):
    return v * v * (1 + pos % 2)


def t_metric(pos, v):
    return v * v * (1 + pos % 2)


def _inputs(h, w, seed=0, m=1):
    rng = np.random.default_rng(seed)
    rgb = np.stack([_pink_texture(rng, h, w) for _ in range(2)])
    marks = rng.standard_normal((2, m, N)).astype(np.float32)
    return rgb, marks


def _configs(tier, **custom):
    """JAX and port (write, read) configs with the named callables."""
    j = {k: globals()[f"j_{v}"] for k, v in custom.items()}
    t = {k: globals()[f"t_{v}"] for k, v in custom.items()}
    wk = ("custom_insert", "custom_ordering")
    rk = ("custom_extract", "custom_ordering")
    jp_, tp_ = jcfg.Precision(tier), tw.Precision(tier)
    return (jcfg.WriteConfig(precision=jp_,
                             **{k: v for k, v in j.items() if k in wk}),
            jcfg.ReadConfig(precision=jp_,
                            **{k: v for k, v in j.items() if k in rk}),
            tw.WriteConfig(precision=tp_,
                           **{k: v for k, v in t.items() if k in wk}),
            tw.ReadConfig(precision=tp_,
                          **{k: v for k, v in t.items() if k in rk}))


def _sims(ext, marks):
    ext = torch.from_numpy(np.array(ext, dtype=np.float32))
    own = torch.diagonal(tw.similarity(ext, torch.from_numpy(marks[:, 0])))
    rand = np.random.default_rng(99).standard_normal((8, N)).astype(np.float32)
    return own.numpy(), float(tw.similarity(
        ext, torch.from_numpy(rand)).abs().max())


def _agree(j_ext, t_ext, marks, tier):
    j_own, _ = _sims(j_ext, marks)
    t_own, rand = _sims(t_ext, marks)
    gap = 0.01 if tier == "highest" else 0.1
    assert np.all(np.abs(j_own - t_own) <= gap)
    assert np.all(t_own > 6.0) and rand < 4.0


def _step(a, b):
    return int(np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).max())


def _base_indices(rgb, n, tier, jrc, tcr):
    """The base's ranked indices through each package's reader cache."""
    if tier == "highest":
        return (np.asarray(jp.prepare_base(jnp.asarray(rgb), n, jrc)[1]),
                tw.prepare_base(torch.from_numpy(rgb), n, tcr)[1].numpy())
    return (np.asarray(jp.rank_base(jnp.asarray(rgb), n, jrc)[0]),
            tw.rank_base(torch.from_numpy(rgb), n, tcr)[0].numpy())


def _recall(a, b):
    return min(len(np.intersect1d(x, y)) / x.shape[-1] for x, y in zip(a, b))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_custom_insert_and_extract_match_jax(tier, h, w):
    rgb, marks = _inputs(h, w)
    jw, jrc, tcw, tcr = _configs(tier, custom_insert="insert",
                                 custom_extract="extract")
    j_marked = jp.embed(jnp.asarray(rgb), jnp.asarray(marks), jw)
    t_marked = tw.embed(torch.from_numpy(rgb), torch.from_numpy(marks), tcw)
    ji, ti = _base_indices(rgb, N, tier, jrc, tcr)
    assert _recall(ji, ti) >= 0.99
    if np.array_equal(ji, ti):
        assert _step(j_marked, t_marked) <= 1
    j_ext = jp.extract(jnp.asarray(rgb), j_marked, N, jrc)
    t_ext = tw.extract(torch.from_numpy(rgb), t_marked, N, tcr)
    _agree(j_ext, t_ext, marks, tier)
    # The other read of each tier: the reader cache at the fast tiers, the
    # prepared pair (full derived transform) at HIGHEST.
    if tier == "highest":
        j_ext = jp.extract(jnp.asarray(rgb), j_marked, N, jrc,
                           sparse_derived=False)
        t_ext = tw.extract(torch.from_numpy(rgb), t_marked, N, tcr,
                           sparse_derived=False)
    else:
        ji, jv = jp.rank_base(jnp.asarray(rgb), N, jrc)
        j_ext = jp.extract_ranked(jnp.asarray(rgb), j_marked, ji, jv, jrc)
        ti, tv = tw.rank_base(torch.from_numpy(rgb), N, tcr)
        t_ext = tw.extract_ranked(torch.from_numpy(rgb), t_marked, ti, tv, tcr)
    _agree(j_ext, t_ext, marks, tier)
    # Without the matching extract the built-in Option2 inverse reads a
    # weaker, distorted mark: the callables were applied.
    plain = tw.extract(torch.from_numpy(rgb), t_marked, N,
                       tw.ReadConfig(precision=tw.Precision(tier)))
    assert np.all(_sims(plain, marks)[0] < _sims(t_ext, marks)[0])


@pytest.mark.parametrize("tier", TIERS)
def test_custom_ordering_matches_jax(tier):
    rgb, marks = _inputs(64, 96, seed=1)
    jw, jrc, tcw, tcr = _configs(tier, custom_ordering="metric")
    ji, ti = _base_indices(rgb, N, tier, jrc, tcr)
    assert _recall(ji, ti) >= 0.99
    j_marked, j_ext = jp.embed_verified(jnp.asarray(rgb), jnp.asarray(marks),
                                        jw)
    t_marked, t_ext = tw.embed_verified(torch.from_numpy(rgb),
                                        torch.from_numpy(marks), tcw)
    assert _step(j_marked, t_marked) <= 1
    _agree(j_ext, t_ext, marks, tier)
    # The reader with the same metric reads what embed_verified read.
    torch.testing.assert_close(
        tw.extract(torch.from_numpy(rgb), t_marked, N, tcr), t_ext,
        rtol=0, atol=0)


@pytest.mark.parametrize("version", [1, 2])
def test_custom_metric_selection_on_one_plane(version):
    # Fast tiers: both packages on JAX's own bf16 plane, jitted.
    rng = np.random.default_rng(5)
    rgb = jnp.asarray(np.stack([_pink_texture(rng, 64, 96) for _ in range(2)]))
    plane = jp._second_pass(jp._half_pass(rgb, jcfg.Precision.DEFAULT, -2), -2)
    select = jax.jit(jr.approx_top_indices,
                     static_argnames=("n", "ordering", "custom_metric",
                                      "version"))
    ji, jv = (np.asarray(a) for a in select(
        plane, n=N, ordering=jcfg.Ordering.ENERGY, custom_metric=j_metric,
        version=version))
    ti, tv = tr.approx_top_indices(
        torch.from_numpy(np.array(plane.astype(jnp.float32))).to(
            torch.bfloat16), N, tw.Ordering.ENERGY, custom_metric=t_metric,
        version=version)
    assert _recall(ji, ti.numpy()) >= 0.99
    for b in range(2):
        jmap = dict(zip(ji[b].tolist(), jv[b].tolist()))
        common = np.intersect1d(ji[b], ti[b].numpy())
        tmap = dict(zip(ti[b].tolist(), tv[b].tolist()))
        assert all(jmap[i] == tmap[i] for i in common.tolist())
    # HIGHEST: top_indices on one f32 plane, index for index.
    coeffs = np.array(jp._forward(rgb, jcfg.Precision.HIGHEST))
    for n, exact_only in ((N, False), (N, True), (20, False)):
        j = jax.jit(jr.top_indices, static_argnums=(1, 2, 3, 4))(
            jnp.asarray(coeffs), n, jcfg.Ordering.ENERGY, exact_only,
            j_metric)
        t = tr.top_indices(torch.from_numpy(coeffs), n, tw.Ordering.ENERGY,
                           exact_only, custom_metric=t_metric)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_custom_insert_with_several_marks_matches_jax():
    rng = np.random.default_rng(6)
    orig = rng.standard_normal((2, N)).astype(np.float32) * 40
    marks = rng.standard_normal((2, 3, N)).astype(np.float32)
    idx = np.stack([rng.permutation(5000)[:N] for _ in range(2)])
    j = jax.jit(jm.embed_marks, static_argnums=(2, 3, 4))(
        jnp.asarray(orig), jnp.asarray(marks), jcfg.Method.OPTION2, A,
        j_insert, jnp.asarray(idx, jnp.int32))
    t = tm.embed_marks(torch.from_numpy(orig), torch.from_numpy(marks),
                       tw.Method.OPTION2, A, custom_insert=t_insert,
                       indices=torch.from_numpy(idx))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("tier", TIERS)
def test_builtin_reimplemented_as_callables(tier):
    rgb, marks = _inputs(64, 96, seed=2)
    base, m = torch.from_numpy(rgb), torch.from_numpy(marks)
    p = tw.Precision(tier)
    builtin = tw.embed(base, m, tw.WriteConfig(precision=p))
    option2 = tw.embed(base, m, tw.WriteConfig(
        precision=p, custom_insert=lambda i, o, w: o * (1.0 + A * w)))
    torch.testing.assert_close(option2, builtin, rtol=0, atol=0)

    ext = tw.extract(base, builtin, N, tw.ReadConfig(precision=p))
    inverse = tw.extract(base, builtin, N, tw.ReadConfig(
        precision=p, custom_extract=lambda i, b, d: (d - b) / (b * A)))
    own = [torch.diagonal(tw.similarity(e, m[:, 0])) for e in (ext, inverse)]
    assert bool(((own[0] - own[1]).abs() <= 1e-3).all())

    energy = lambda i, v: v * v  # noqa: E731
    read = tw.prepare_base if p is tw.Precision.HIGHEST else tw.rank_base
    a = read(base, N, tw.ReadConfig(precision=p))
    b = read(base, N, tw.ReadConfig(precision=p, custom_ordering=energy))
    i, j = (x[1] if p is tw.Precision.HIGHEST else x[0] for x in (a, b))
    if p is tw.Precision.HIGHEST:
        torch.testing.assert_close(i, j, rtol=0, atol=0)
    else:
        assert _recall(i.numpy(), j.numpy()) >= 0.95


@pytest.mark.parametrize("tier", TIERS)
def test_embed_verified_refuses_custom_insert_in_both(tier):
    rgb, marks = _inputs(37, 59, seed=3)
    jw, _, tcw, _ = _configs(tier, custom_insert="insert")
    with pytest.raises(ValueError, match="custom_insert") as j:
        jp.embed_verified(jnp.asarray(rgb), jnp.asarray(marks), jw)
    with pytest.raises(ValueError, match="custom_insert") as t:
        tw.embed_verified(torch.from_numpy(rgb), torch.from_numpy(marks), tcw)
    assert str(t.value) == str(j.value)
