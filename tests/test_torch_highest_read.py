"""K9, the HIGHEST read, on the CPU: its plain version against the JAX
package's ``dct2_coeffs_at`` of the u8 luma, an emulation of the kernel's
order of operations against the plain version within ``k9_bound``, planted
faults that the gates must catch, and the wrapper's checks and CPU
dispatch. The kernel itself runs only on a CUDA card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it against these
plain versions there."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_torch import (Precision, ReadConfig,
                                                WriteConfig)
from spread_spectrum_watermarking_torch.kernels import highest_read as k9
from spread_spectrum_watermarking_torch.kernels import launch_counts
from spread_spectrum_watermarking_torch.kernels import read_tail as k5
from spread_spectrum_watermarking_torch.kernels.dct2d_fused import split_tf32
from spread_spectrum_watermarking_torch.models import pipeline as tp
from spread_spectrum_watermarking_torch.ops import colorspace, dct
from spread_spectrum_watermarking_tpu.ops import colorspace as jcs
from spread_spectrum_watermarking_tpu.ops import dct as jd

GEOMETRIES = [(64, 96), (96, 64), (37, 53)]
# The first pass's k-step, whose tensor-core sum is added to the f32 total
# (csrc/highest_read.cu, pass_kernel: a wgmma k-step of 8), and the dots'
# chunk and lanes (dot_kernel there).
STEP, CHUNK, LANES = 8, 4, 32
_SOURCE = (Path(__file__).resolve().parent.parent
           / "spread_spectrum_watermarking_torch" / "csrc" / "highest_read.cu")


def _constant(name):
    """An int constant of the kernel's source (``constexpr int name = v;``)."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _SOURCE.read_text()).group(1))


# A tile's slots, and its positions: 64 (wgmma's m) per consumer warpgroup.
SLOTS, COLS = _constant("kSlots"), 64 * _constant("kConsumers")


def _inputs(seed, h, w, n, b=3, kind="distinct"):
    """(u8 images, int64 (b, n) flat indices): distinct random indices, or
    ``rows``: many in three rows of the shorter axis, one index repeated."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
    if kind == "distinct":
        idx = np.stack([rng.choice(h * w, n, replace=False) for _ in range(b)])
    else:
        a = rng.integers(0, min(h, w), (b, n)) % 3
        c = rng.integers(0, max(h, w), (b, n))
        idx = a * w + c if h <= w else c * w + a
        idx[:, n // 2:] = idx[:, :1]
    return x, torch.from_numpy(idx.astype(np.int64))


def _cases():
    for h, w in GEOMETRIES:
        for n in (1, 200, h * w - 1):
            yield h, w, n, "distinct"
        yield h, w, 150, "rows"


CASES = list(_cases())


@jax.jit
def _jax_read(x, idx):
    return jd.dct2_coeffs_at(jcs.rgb_to_luma(jcs.u8_to_f32(x)), idx)


def _emulate(y, idx, fault=None):
    """The kernel's order of operations in plain torch
    (``csrc/highest_read.cu``). The compaction
    (``read_tail.compact_rows_reference``): each image's distinct rows
    along S, a slot per index. The first pass (``pass_kernel``) at the
    listed rows only, as K6a's 3xTF32 (``csrc/tf32x3.cuh``): both operands
    split (``split_tf32``); for each k-step of 8, the products lo_b hi_y,
    hi_b lo_y, hi_b hi_y summed from zero (exact products, f32 sums), the
    step's sum then added to the f32 total; D a row per slot. Its tiles,
    walk and overlap (:func:`_slot_tiles`) change which block computes an
    output and when, not how. The dot of each
    index with its slot's row: lane q of 32 over the chunks of 4 columns
    l = 4 (q + 32 k) + e, one f32 FMA chain per e with k ascending, then
    (s0 + s1) + (s2 + s3), the lanes added as the xor shuffles 16, 8, 4,
    2, 1 add them. Elementwise f32 ops per image, so an image's result
    cannot depend on its batch.

    ``fault`` plants a defect a wrong kernel could have: ``"lo"`` the
    split's lo terms dropped (a 1xTF32 pass), ``"slot"`` slots 0 and 1
    swapped (where an image has one row, slot 1 is a zero row),
    ``"bf16"`` D rounded to bf16."""
    b_, h, w = y.shape
    land = h <= w
    s, l = min(h, w), max(h, w)
    idx = idx.expand(b_, idx.shape[-1])
    bcoord = idx % w if land else idx // w
    _, rows, slot = k5.compact_rows_reference(idx, h, w, b_)
    if fault == "slot":
        slot = torch.where(slot == 0, 1, torch.where(slot == 1, 0, slot))
    cs = dct.basis_tensor(s, y.device, torch.float32)
    cl = dct.basis_tensor(l, y.device, torch.float32)
    out = []
    for i in range(b_):
        y_hi, y_lo = split_tf32(y[i] if land else y[i].t())  # (S, L)
        listed = rows[i][rows[i] >= 0]
        c_hi, c_lo = split_tf32(cs[listed])                  # (R, S)
        acc = torch.zeros((listed.numel(), l))
        for q in range(0, s, STEP):
            ks = slice(q, min(q + STEP, s))
            terms = ([(c_hi, y_hi)] if fault == "lo" else
                     [(c_hi, y_lo), (c_lo, y_hi), (c_hi, y_hi)])
            part = torch.zeros_like(acc)
            for cp, yp in terms:
                part = part + (cp[:, ks, None] * yp[None, ks]).sum(1)
            acc = acc + part
        if fault == "bf16":
            acc = acc.to(torch.bfloat16).float()
        acc = torch.nn.functional.pad(
            acc, (0, 0, 0, rows.shape[-1] + 1 - listed.numel()))
        width = -(-l // (CHUNK * LANES)) * CHUNK * LANES
        d, c = (torch.nn.functional.pad(t, (0, width - l)).reshape(
            idx.shape[-1], -1, LANES, CHUNK)                 # l = 4 (32 k + q) + e
            for t in (acc[slot[i]], cl[bcoord[i]]))
        sums = torch.zeros((idx.shape[-1], LANES, CHUNK))
        for k in range(d.shape[1]):
            sums = colorspace._fma_f32(d[:, k], c[:, k], sums)
        lane = (sums[..., 0] + sums[..., 1]) + (sums[..., 2] + sums[..., 3])
        while lane.shape[-1] > 1:
            half = lane.shape[-1] // 2
            lane = lane[..., :half] + lane[..., half:]
        out.append(lane[..., 0])
    return torch.stack(out)


@pytest.mark.parametrize("h,w,n,kind", CASES)
def test_reference_matches_jax(h, w, n, kind):
    # The HIGHEST standard: within 1e-4 of the largest coefficient's scale.
    x, idx = _inputs(h * w + n, h, w, n, kind=kind)
    j = np.asarray(_jax_read(jnp.asarray(x.numpy()),
                             jnp.asarray(idx.numpy(), jnp.int32)))
    t = k9.highest_read_reference(colorspace.luma(x), idx)
    assert t.shape == (3, n) and t.dtype == torch.float32
    tol = 1e-4 * max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=tol)


@pytest.mark.parametrize("h,w,n,kind", CASES)
def test_kernel_order_within_k9_bound_of_reference(h, w, n, kind):
    x, idx = _inputs(7 + h + n, h, w, n, kind=kind)
    y = colorspace.luma(x)
    got = _emulate(y, idx)
    want = k9.highest_read_reference(y, idx)
    bound = k9.k9_bound(y, idx)
    assert bool(((got.double() - want.double()).abs() <= bound).all())
    g = k9.gates(got, y, idx)
    assert g["within_bound"] and g["within_f64"] and g["finite"]
    # Both within a few units of the f64 read.
    assert g["kernel_f64_err"] < 4 and g["plain_f64_err"] < 4


@pytest.mark.parametrize("fault", ["lo", "slot", "bf16"])
@pytest.mark.parametrize("h,w,n,kind", CASES)
def test_planted_faults_fail_the_gates(h, w, n, kind, fault):
    # A wrong slot leaves k9_bound; a 1xTF32 first pass (about a hundred
    # units against the f64 read) and a bf16 D fail the f64 gate, and
    # leave the bound too once the dots are long enough.
    x, idx = _inputs(7 + h + n, h, w, n, kind=kind)
    y = colorspace.luma(x)
    g = k9.gates(_emulate(y, idx, fault), y, idx)
    assert not (g["within_bound"] and g["within_f64"])


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_kernel_order_does_not_depend_on_the_batch(h, w):
    # Each image read alone, inside a batch and with a shared index set
    # gives the same bits, and so does a second call.
    x, idx = _inputs(11, h, w, 120)
    y = colorspace.luma(x)
    batch = _emulate(y, idx)
    assert torch.equal(batch, _emulate(y, idx))
    for i in range(3):
        alone = _emulate(y[i:i + 1], idx[i:i + 1])
        assert torch.equal(alone[0], batch[i])
    shared = _emulate(y, idx[1])
    assert torch.equal(shared[1], batch[1])


@pytest.mark.parametrize("h,w", GEOMETRIES + [(40, 300)])
def test_kernel_order_does_not_depend_on_the_row_counts(h, w):
    # One batch holds an image whose indices share one row, one whose
    # indices cover min(n, S) rows and a random one; each reads alone what
    # it reads in the batch.
    n = 150
    x, idx = _inputs(12, h, w, n)
    y = colorspace.luma(x)
    s = min(h, w)
    land = h <= w
    a = np.arange(n) % s
    c = np.arange(n) % max(h, w)
    idx[0] = torch.from_numpy(3 * w + c if land else c * w + 3)
    idx[1] = torch.from_numpy(a * w + c if land else c * w + a)
    count, _, _ = k5.compact_rows_reference(idx, h, w, 3)
    assert count[0] == 1 and count[1] == min(n, s)
    batch = _emulate(y, idx)
    for i in range(3):
        alone = _emulate(y[i:i + 1], idx[i:i + 1])
        assert torch.equal(alone[0], batch[i])
    g = k9.gates(batch, y, idx)
    assert g["within_bound"] and g["within_f64"] and g["finite"]


def _slot_tiles(counts, cap, l, sms):
    """The first pass's walk (``SlotTiles`` and ``launch_pass`` in
    ``csrc/highest_read.cu``) as each block takes it: image by image, of
    each its column tiles of COLS positions, of each the slot tiles of SLOTS
    below the image's count, slot fastest; the grid (at most one block per
    SM, at most the tiles every image at its cap would have) deals them
    out in turn, each block keeping a cursor that only moves forward.
    Returns each block's (image, column tile, slot tile) in its order."""
    col_tiles = -(-l // COLS)
    grid = min(sms, len(counts) * -(-cap // SLOTS) * col_tiles)
    blocks = []
    for b in range(grid):
        image, first, live, got = 0, 0, -1, []
        tile = b
        while True:
            found = None
            while image < len(counts):
                if live < 0:
                    live = -(-counts[image] // SLOTS)
                if tile < first + live * col_tiles:
                    local = tile - first
                    found = (image, local // live, local % live)
                    break
                first += live * col_tiles
                image += 1
                live = -1
            if found is None:
                break
            got.append(found)
            tile += grid
        blocks.append(got)
    return blocks


EDGE_COUNTS = [1, 63, 64, 65, 128, 129]


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("h,w", [(1080, 1920), (1920, 1080), (64, 96),
                                 (96, 64)])
def test_walk_covers_every_live_tile_once(h, w, sms):
    # Counts at the slot tiles' edges and at the cap (min(n, S), n = 1000),
    # in both orientations: every live (image, column tile, slot tile) is
    # taken by exactly one block, none past an image's count, every slot
    # below the count and every position below L lies in a taken tile, and
    # an image computes fewer than SLOTS rows past its count.
    s, l = min(h, w), max(h, w)
    cap = min(1000, s)
    counts = [c for c in EDGE_COUNTS if c <= cap] + [cap]
    blocks = _slot_tiles(counts, cap, l, sms)
    taken = [t for got in blocks for t in got]
    assert len(taken) == len(set(taken))
    col_tiles = -(-l // COLS)
    live = {(i, c, k) for i, n in enumerate(counts) for c in range(col_tiles)
            for k in range(-(-n // SLOTS))}
    assert set(taken) == live
    for i, n in enumerate(counts):
        rows = {k * SLOTS + r for (j, _, k) in taken if j == i
                for r in range(SLOTS)}
        assert set(range(n)) <= rows and len(rows) - n < SLOTS
        assert all(k * SLOTS < n for (j, _, k) in taken if j == i)
    assert col_tiles * COLS >= l > (col_tiles - 1) * COLS
    # A block's tiles come in the walk's order (image, column tile, slot
    # tile), so its cursor only moves forward; a block finds no tile only
    # where fewer tiles are live than blocks were launched.
    rank = {t: i for i, t in enumerate(sorted(live))}
    for got in blocks:
        assert [rank[t] for t in got] == sorted(rank[t] for t in got)
    assert sum(not got for got in blocks) == max(0, len(blocks) - len(live))


def test_walk_with_one_row_an_image_is_one_slot_tile_each():
    # Textures need about 57 rows an image: one slot tile each, where the
    # 128-slot tiles of K6a's form computed 128 rows.
    blocks = _slot_tiles([57] * 48, 1000, 1920, 132)
    taken = [t for got in blocks for t in got]
    assert len(taken) == 48 * -(-1920 // COLS)
    assert {k for (_, _, k) in taken} == {0}


def test_tile_shape_matches_the_source():
    # 64 slots (wgmma's n of m64n64k8) by three consumer warpgroups of 64
    # positions: the numbers the walk model and the design note use.
    assert (SLOTS, COLS) == (64, 192)
    text = _SOURCE.read_text()
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in (
        _SOURCE.parent / "tf32x3.cuh").read_text()
    assert "wgmma_n64(p, al[q], dh + 2 * q, 0);" in text


def _chunk_of(p, rho):
    """``chunk_of`` of ``csrc/tma_ring.cuh``: the 16-byte chunk of its
    32-position box that fragment row rho of warp p (of the pair sharing
    the box) stands for in landscape."""
    return 4 * ((rho // 4) % 2) + rho // 8 + 2 * p


def _sw128(r, k):
    """``sw128`` of ``csrc/tf32x3.cuh``: element (r, k) of a tile of
    128-byte rows in wgmma's 128-byte swizzle, in floats."""
    return r * 32 + ((((k >> 2) ^ r) & 7) << 2) + (k & 3)


def test_fragment_positions_and_banks():
    # In landscape the pair of warps sharing a box gives its 32 fragment
    # rows the box's 32 positions once each, and each of a warp's four
    # fragment loads (rows g, g + 8 at k-rows t, t + 4 of k-step q) hits
    # 32 different banks; in portrait (rows = positions, 32 k each) too.
    assert "return 4 * ((rho / 4) % 2) + rho / 8 + 2 * p;" in (
        _SOURCE.parent / "tma_ring.cuh").read_text()
    assert "return r * kRowFloats + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);" \
        in (_SOURCE.parent / "tf32x3.cuh").read_text()
    pos = sorted(4 * _chunk_of(p, rho) + rho % 4 for p in (0, 1)
                 for rho in range(16))
    assert pos == list(range(32))
    for land in (True, False):
        for warp in range(4):
            for q in range(4):
                for e in range(4):
                    banks = set()
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        rho, k = g + 8 * (e % 2), 8 * q + t + 4 * (e // 2)
                        if land:
                            at = 1024 * (warp // 2) + _sw128(
                                k, 4 * _chunk_of(warp % 2, rho) + rho % 4)
                        else:
                            at = _sw128(16 * warp + rho, k)
                        banks.add(at % 32)
                    assert len(banks) == 32, (land, warp, q, e)


@pytest.mark.parametrize("case", ["distinct", "rows", "shared", "all"])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_compaction_matches_torch_unique(h, w, case):
    # K9's compaction is K5's (csrc/compact_rows.cuh): each image's count
    # of distinct rows, the rows ascending and each index's slot are
    # torch.unique's values, count and inverse, up to n = S L - 1.
    n = h * w - 1 if case == "all" else 200
    x, idx = _inputs(8, h, w, n, b=2, kind="rows" if case == "rows"
                     else "distinct")
    if case == "shared":
        idx = idx[0]
    count, rows, slot = k5.compact_rows_reference(idx, h, w, 2)
    full = idx.expand(2, idx.shape[-1])
    assert rows.shape == (2, min(idx.shape[-1], min(h, w)))
    for i in range(2):
        a = full[i] // w if h <= w else full[i] % w
        uniq, inverse = torch.unique(a, sorted=True, return_inverse=True)
        assert int(count[i]) == uniq.numel()
        assert torch.equal(rows[i, :uniq.numel()], uniq)
        assert bool((rows[i, uniq.numel():] == -1).all())
        assert torch.equal(slot[i], inverse)


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_cpu_dispatch_takes_the_reference_and_counts_no_launch(h, w):
    x, idx = _inputs(2, h, w, 200)
    y = colorspace.luma(x)
    before = launch_counts()
    want = k9.highest_read_reference(y, idx)
    assert torch.equal(k9.highest_read(y, idx), want)
    # One index set for the batch reads as that set repeated.
    assert torch.equal(k9.highest_read(y, idx[0]),
                       k9.highest_read_reference(y, idx[0].expand(3, -1)))
    # The reference is today's route, dct2_coeffs_at, bit for bit, and so
    # is the pipeline's HIGHEST read of a u8 image on the CPU.
    assert torch.equal(want, dct.dct2_coeffs_at(y, idx))
    assert torch.equal(tp._read_highest(x, idx), want)
    assert launch_counts() == before


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_highest_reads_on_the_cpu_are_the_plain_route(h, w):
    # embed_verified's and extract's HIGHEST reads, from u8 and from float
    # images, are the plain route's bits on the CPU, with no launch.
    rng = np.random.default_rng(5)
    x, _ = _inputs(5, h, w, 1, b=2)
    marks = torch.from_numpy(rng.standard_normal((2, 1, 40)).astype(
        np.float32))
    cfg, rcfg = (WriteConfig(precision=Precision.HIGHEST),
                 ReadConfig(precision=Precision.HIGHEST))
    before = launch_counts()
    marked, ext = tp.embed_verified(x, marks, cfg)
    for base, derived in ((x, marked), (x.float() / 255.0,
                                        marked.float() / 255.0)):
        flat, idx = tp.prepare_base(base, 40, rcfg)
        plain = tp._extract_values(
            rcfg, idx, torch.gather(flat, -1, idx),
            dct.dct2_coeffs_at(colorspace.luma(derived), idx))
        got = tp.extract(base, derived, 40, rcfg)
        torch.testing.assert_close(got, plain, rtol=0, atol=0,
                                   equal_nan=True)
        if base.dtype == torch.uint8:
            torch.testing.assert_close(ext, plain, rtol=0, atol=0,
                                       equal_nan=True)
    assert launch_counts() == before


@pytest.mark.parametrize("bad", ["y_dtype", "y_rank", "idx_dtype",
                                 "idx_batch", "idx_rank", "idx_low",
                                 "idx_high", "device"])
def test_argument_checks_raise(bad):
    x, idx = _inputs(3, 37, 53, 20)
    y = colorspace.luma(x)
    if bad == "y_dtype":
        y = y.double()
    elif bad == "y_rank":
        y = y[0]
    elif bad == "idx_dtype":
        idx = idx.int()
    elif bad == "idx_batch":
        idx = idx[:1]
    elif bad == "idx_rank":
        idx = idx[None]
    elif bad == "idx_low":
        idx[0, 3] = -1
    elif bad == "idx_high":
        idx[1, 0] = 37 * 53
    else:
        y = torch.empty(y.shape, device="meta")
    with pytest.raises(ValueError):
        k9.highest_read(y, idx)
