"""K10, HIGHEST's sparse inverse, on the CPU: its plain version against the
route the port ran before it and against the JAX package's
``_sparse_idct_delta``, an emulation of the kernel's order of operations
within ``k10_bound``, planted faults that the gates must catch, a model of
the kernel's stable sort of the indices by slot, the HIGHEST embed through
the wrapper against JAX's, and the wrapper's checks and CPU dispatch. The
kernel itself runs only on a CUDA card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against these plain versions there."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_torch.kernels import add_quantize as k7
from spread_spectrum_watermarking_torch.kernels import highest_inverse as k10
from spread_spectrum_watermarking_torch.kernels import launch_counts
from spread_spectrum_watermarking_torch.kernels import read_tail as k5
from spread_spectrum_watermarking_torch.kernels.dct2d_fused import (
    inverse_scale, split_tf32)
from spread_spectrum_watermarking_torch.models import pipeline as tp
from spread_spectrum_watermarking_torch.ops import colorspace, dct
from spread_spectrum_watermarking_tpu import config as jcfg
from spread_spectrum_watermarking_tpu.models import pipeline as jp

GEOMETRIES = [(37, 59), (59, 37), (64, 96), (96, 64)]
# The product's k-step, whose tensor-core sum is added to the f32 total
# (csrc/highest_inverse.cu, pass_kernel: a wgmma k-step of 8 slots).
STEP = 8
_SOURCE = (Path(__file__).resolve().parent.parent
           / "spread_spectrum_watermarking_torch" / "csrc"
           / "highest_inverse.cu")


def _inputs(seed, h, w, n, b, kind="distinct"):
    """(u8 images, f32 (b, n) updates, int64 (b, n) flat indices): distinct
    random indices, or ``rows``: distinct indices on at most three rows of
    the shorter axis, so that many share a row (n may exceed S)."""
    rng = np.random.default_rng(seed)
    rgb = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
    delta = torch.from_numpy(
        (rng.standard_normal((b, n)) * 20.0).astype(np.float32))
    s, l = min(h, w), max(h, w)
    if kind == "distinct":
        idx = np.stack([rng.choice(h * w, n, replace=False)
                        for _ in range(b)])
    else:
        idx = []
        for _ in range(b):
            rows = rng.choice(s, min(3, s), replace=False)
            at = rng.choice(len(rows) * l, n, replace=False)
            a, c = rows[at // l], at % l
            idx.append(a * w + c if h <= w else c * w + a)
        idx = np.stack(idx)
    return rgb, delta, torch.from_numpy(idx.astype(np.int64))


def _cases():
    for h, w in GEOMETRIES:
        s = min(h, w)
        for b, n in ((1, 1), (2, 50), (3, s + 20)):
            yield h, w, n, b, "distinct"
        yield h, w, 2 * s + 5, 2, "rows"


CASES = list(_cases())


def _old_dy(delta, idx, h, w):
    """The HIGHEST dY as the port computed it before K10
    (``models/pipeline.py``, ``_sparse_idct_delta`` at HIGHEST)."""
    a, b = dct.sparse_factors_f32(delta, idx, h, w)
    return dct.matmul(a.transpose(-1, -2), b, tw.Precision.HIGHEST) * \
        inverse_scale(h, w)


def _emulate(delta, idx, h, w, tf32=True, fault=None):
    """The kernel's order of operations in plain numpy and torch
    (``csrc/highest_inverse.cu``). The compaction
    (``read_tail.compact_rows_reference``): each image's distinct rows A
    along S, a slot per index. M (``mbuild_kernel``): per slot, f32
    products delta_i D_L[l, b_i] added in f32, i ascending, from zero. The
    product (``pass_kernel``): with ``tf32``, K9's 3xTF32 (both operands
    split, ``split_tf32``; for each k-step of 8 slots the products lo_M
    hi_D, hi_M lo_D, hi_M hi_D summed exactly, rounded to f32, then added
    to the f32 total); without, in f64 and rounded once. Then one f32
    product by s. Its tiles and walk change which block computes a pixel
    and when, not how.

    ``fault`` plants a defect a wrong kernel could have: ``"lo"`` the
    split's lo terms dropped (a 1xTF32 product), ``"slot"`` M's rows 0 and
    1 swapped, ``"bf16"`` M rounded to bf16."""
    b_, n = delta.shape
    land = h <= w
    s, l = min(h, w), max(h, w)
    idx = idx.expand(b_, n)
    bcoord = (idx % w if land else idx // w).numpy()
    count, rows, slot = k5.compact_rows_reference(idx, h, w, b_)
    ds = dct.basis_tensor(s, "cpu", torch.float32, inverse=True)
    dl = dct.basis_tensor(l, "cpu", torch.float32, inverse=True).numpy()
    scale = np.float32(inverse_scale(h, w))
    out = np.zeros((b_, h, w), np.float32)
    d = delta.numpy()
    for im in range(b_):
        c = int(count[im])
        m = np.zeros((c, l), np.float32)
        for i in range(n):  # i ascending within each slot
            j = int(slot[im, i])
            m[j] = m[j] + d[im, i] * dl[:, bcoord[im, i]]
        if fault == "slot" and c > 1:
            m[[0, 1]] = m[[1, 0]]
        mt = torch.from_numpy(m)
        if fault == "bf16":
            mt = mt.to(torch.bfloat16).float()
        dsa = ds[:, rows[im, :c]]                               # (S, c)
        if tf32:
            acc = torch.zeros((s, l))
            for q in range(0, c, STEP):
                dp, mp = dsa[:, q:q + STEP], mt[q:q + STEP]
                d_hi, d_lo = split_tf32(dp)
                m_hi, m_lo = split_tf32(mp)
                terms = ([(d_hi, m_hi)] if fault == "lo" else
                         [(d_hi, m_lo), (d_lo, m_hi), (d_hi, m_hi)])
                part = sum(x.double() @ y.double() for x, y in terms)
                acc = acc + part.float()
        else:
            acc = (dsa.double() @ mt.double()).float()
        dy = acc.numpy() * scale
        out[im] = dy if land else dy.T
    return torch.from_numpy(out)


@pytest.mark.parametrize("h,w,n,b,kind", CASES)
def test_cpu_route_is_the_old_route_bit_for_bit(h, w, n, b, kind):
    # The plain version is the route the port ran before K10: the same dY
    # and the same u8, bit for bit, in both modes.
    rgb, delta, idx = _inputs(1, h, w, n, b, kind)
    old = _old_dy(delta, idx, h, w)
    assert torch.equal(k10.sparse_delta(delta, idx, h, w), old)
    assert torch.equal(tp._sparse_idct_delta(delta, idx, h, w,
                                             tw.Precision.HIGHEST), old)
    assert torch.equal(k10.highest_inverse(rgb, delta, idx),
                       k7.add_quantize(rgb, old, True))


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_plain_version_is_jax_sparse_inverse(h, w):
    # The same f32 terms, summed in XLA's order: within k10_bound.
    _, delta, idx = _inputs(2, h, w, 120, 2)
    j = jax.jit(lambda d, i: jp._sparse_idct_delta(
        d, i, h, w, jcfg.Precision.HIGHEST))(jnp.asarray(delta.numpy()),
                                              jnp.asarray(idx.numpy()))
    t = k10.sparse_delta_reference(delta, idx, h, w)
    d = (t.double() - torch.from_numpy(np.array(j)).double()).abs()
    assert bool((d <= k10.k10_bound(delta, idx, h, w)).all())


@pytest.mark.parametrize("tf32", [True, False])
@pytest.mark.parametrize("h,w,n,b,kind", CASES)
def test_emulation_within_bound(h, w, n, b, kind, tf32):
    # The kernel's algebra (over the distinct rows, M's f32 sums in
    # ascending i, the 3xTF32 or an exact product) passes the gates.
    rgb, delta, idx = _inputs(3, h, w, n, b, kind)
    dy = _emulate(delta, idx, h, w, tf32=tf32)
    out = k7.add_quantize_reference(rgb, dy, True)
    g = k10.gates(dy, delta, idx, rgb, out)
    assert g["within_bound"] and g["within_f64"] and g["finite"], g
    assert g["u8_bit_equal_own_dy"] and g["max_u8_step_from_plain"] <= 1, g
    assert g["max_share_of_bound_used"] < 0.5, g


@pytest.mark.parametrize("h,w,n,b,kind", CASES)
def test_plain_f64_error_within_bound(h, w, n, b, kind):
    # The bound holds each route to the f64 dY of the f32 operands too.
    _, delta, idx = _inputs(4, h, w, n, b, kind)
    ref = k10.sparse_delta_reference(delta, idx, h, w)
    for i, (exact, mag, rows) in enumerate(k10._terms(delta, idx, h, w)):
        bound = k10._bound_terms(rows, n) * 2.0 ** -24 * mag
        assert bool(((ref[i].double() - exact).abs() <= bound).all())
    assert k10.f64_error(ref, delta, idx) < 2 * n + 2


@pytest.mark.parametrize("fault,gate", [("lo", "within_f64"),
                                        ("slot", "within_bound"),
                                        ("bf16", "within_f64")])
@pytest.mark.parametrize("h,w", [(64, 96), (96, 64)])
def test_planted_faults_fail_the_gates(h, w, fault, gate):
    rgb, delta, idx = _inputs(5, h, w, 250, 2, "rows")
    good = k10.gates(_emulate(delta, idx, h, w), delta, idx)
    assert good["within_bound"] and good["within_f64"], good
    bad = k10.gates(_emulate(delta, idx, h, w, fault=fault), delta, idx)
    assert not bad[gate], bad


def _order_model(slots, rows):
    """order_kernel of csrc/highest_inverse.cu in Python: one warp counts
    the slots 32 positions at a time (the lowest lane of each group of
    equal slots adds the group's size), scans the counts, then places each
    position (the kernel writes its coordinate along L and its update
    there) at its slot's cursor plus its rank among the equal slots of
    lower lanes, and moves the cursors on by the group sizes."""
    n = len(slots)
    counts = [0] * rows
    for i0 in range(0, n, 32):
        chunk = slots[i0:i0 + 32]
        for s in set(chunk):
            counts[s] += chunk.count(s)
    start = list(np.concatenate([[0], np.cumsum(counts)]).astype(int))
    cursor, order = start[:-1], [None] * n
    for i0 in range(0, n, 32):
        chunk = slots[i0:i0 + 32]
        for lane, s in enumerate(chunk):
            order[cursor[s] + chunk[:lane].count(s)] = i0 + lane
        for s in set(chunk):
            cursor[s] += chunk.count(s)
    return start, order


@pytest.mark.parametrize("h,w,n,b,kind", CASES)
def test_order_is_a_stable_sort_by_slot(h, w, n, b, kind):
    # Slot j's indices are order[start[j]:start[j + 1]], i ascending: the
    # order M's sums take.
    _, _, idx = _inputs(6, h, w, n, b, kind)
    count, _, slot = k5.compact_rows_reference(idx, h, w, b)
    for im in range(b):
        s = slot[im].tolist()
        start, order = _order_model(s, int(count[im]))
        assert order == np.argsort(s, kind="stable").tolist()
        assert start[-1] == n and all(
            s[order[k]] == j for j in range(int(count[im]))
            for k in range(start[j], start[j + 1]))


def _pink(h, w, b, seed):
    from spread_spectrum_watermarking_tpu.bench import _pink_texture
    rng = np.random.default_rng(seed)
    return np.stack([_pink_texture(rng, h, w) for _ in range(b)])


def _counting(monkeypatch):
    calls = {"highest_inverse": 0, "sparse_delta": 0}
    for name in calls:
        real = getattr(tp, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tp, name, counted)
    return calls


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_highest_embed_through_k10_matches_jax(h, w, monkeypatch):
    # embed and embed_verified of a u8 image call the u8 mode once and stay
    # within one u8 step of JAX's embed; the sigmas within 0.01 of JAX's.
    rgb = _pink(h, w, 2, 7)
    marks = np.random.default_rng(7).standard_normal((2, 1, 100)).astype(
        np.float32)
    jm, je = jp.embed_verified(jnp.asarray(rgb), jnp.asarray(marks))
    calls = _counting(monkeypatch)
    tm = tw.embed(torch.from_numpy(rgb), torch.from_numpy(marks))
    tm2, te = tw.embed_verified(torch.from_numpy(rgb),
                                torch.from_numpy(marks))
    assert calls == {"highest_inverse": 2, "sparse_delta": 0}
    assert torch.equal(tm, tm2) and tm.dtype == torch.uint8
    assert int(np.abs(np.asarray(jm).astype(int) - tm.numpy()).max()) <= 1
    own = [torch.diagonal(tw.similarity(torch.from_numpy(np.asarray(e)),
                                        torch.from_numpy(marks[:, 0])))
           for e in (je, te)]
    assert bool(((own[0] - own[1]).abs() <= 0.01).all())
    assert bool((own[1] > 6.0).all())


@pytest.mark.parametrize("h,w", [(37, 59), (64, 96)])
def test_embed_highest_routes_float_output_through_dy_mode(h, w,
                                                           monkeypatch):
    # quantize=False on a u8 image and a float image take K10's dY mode,
    # once, then K7's f32 mode or the float add; a u8 image quantized to u8
    # takes the u8 mode; the full inverse takes neither.
    rgb = torch.from_numpy(_pink(h, w, 2, 8))
    marks = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 1, 60)).astype(np.float32))
    calls = _counting(monkeypatch)
    marked = tw.embed(rgb, marks)
    assert calls == {"highest_inverse": 1, "sparse_delta": 0}
    f32 = tw.embed(rgb, marks, quantize=False)
    assert calls == {"highest_inverse": 1, "sparse_delta": 1}
    assert torch.equal(colorspace.f32_to_u8(f32), marked)
    tw.embed(rgb.float() / 255.0, marks)
    assert calls == {"highest_inverse": 1, "sparse_delta": 2}
    tw.embed(rgb, marks, sparse_idct=False)
    assert calls == {"highest_inverse": 1, "sparse_delta": 2}


def test_wrappers_refuse_what_the_kernel_does_not_take():
    rgb, delta, idx = _inputs(9, 37, 59, 20, 2)
    with pytest.raises(ValueError):
        k10.highest_inverse(rgb, delta.double(), idx)      # delta not f32
    with pytest.raises(ValueError):
        k10.highest_inverse(rgb, delta[0], idx)            # delta not (B, n)
    with pytest.raises(ValueError):
        k10.highest_inverse(rgb, delta, idx.int())         # int32 indices
    with pytest.raises(ValueError):
        k10.highest_inverse(rgb, delta, idx[:, :10])       # n differs
    with pytest.raises(ValueError):
        k10.highest_inverse(rgb.float(), delta, idx)       # image not u8
    with pytest.raises(ValueError):
        k10.highest_inverse(rgb[:1], delta, idx)           # batch differs
    with pytest.raises(ValueError):
        k10.highest_inverse(rgb[..., :2], delta, idx)      # not RGB
    with pytest.raises(ValueError):
        k10.sparse_delta(delta, idx, 0, 59)                # no pixel
    for bad in (-1, 37 * 59):
        wrong = idx.clone()
        wrong[1, 3] = bad
        with pytest.raises(ValueError):
            k10.sparse_delta(delta, wrong, 37, 59)         # out of range
        with pytest.raises(ValueError):
            k10.highest_inverse(rgb, delta, wrong)
    # One index set for the batch, and a strided view of the image.
    shared = k10.highest_inverse(rgb, delta, idx[0])
    assert torch.equal(shared, k10.highest_inverse(rgb, delta,
                                                   idx[0].expand(2, -1)))
    view = rgb.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(k10.highest_inverse(view, delta, idx),
                       k10.highest_inverse(rgb, delta, idx))


def test_cpu_calls_do_not_count_as_launches():
    rgb, delta, idx = _inputs(10, 37, 59, 20, 2)
    before = launch_counts()["k10"]
    k10.highest_inverse(rgb, delta, idx)
    k10.sparse_delta(delta, idx, 37, 59)
    assert launch_counts()["k10"] == before


def test_constants_match_the_source():
    # M's rows are padded to the pass's k-depth; the k-step of the
    # emulation is wgmma's k of m64n64k8.tf32, whose three products the
    # kernel issues in the emulation's term order (M the A operand, from
    # registers; D_S's listed columns, G, the B operand): lo_M hi_D, hi_M
    # lo_D, hi_M hi_D; the u8 rounding is K7's, from its header.
    text = _SOURCE.read_text()
    assert re.search(r"constexpr int kDepth = kRowFloats;", text)
    assert k10._DEPTH == 32
    terms = ["wgmma_n64(p, al[q], dh + 2 * q, 0);",
             "wgmma_n64(p, ah[q], dl + 2 * q, 1);",
             "wgmma_n64(p, ah[q], dh + 2 * q, 1);"]
    at = [text.index(x) for x in terms]
    assert at == sorted(at)
    assert "#include \"u8_round.cuh\"" in text
    assert "round_byte(" in text
