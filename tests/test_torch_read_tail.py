"""K5, the fast tiers' read tail, on the CPU: its plain version against the
JAX package's read tail, an emulation of the kernel's order of operations
against the plain version within ``k5_bound``, planted faults that the
gates must catch, and the wrapper's checks and CPU dispatch. The kernel
itself runs only on a CUDA card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_torch import (InsertExtract, Method,
                                                Precision, ReadConfig)
from spread_spectrum_watermarking_torch.kernels import read_tail as k5
from spread_spectrum_watermarking_torch.kernels.luma_pass import (
    luma_pass_reference)
from spread_spectrum_watermarking_torch.models import pipeline as tp
from spread_spectrum_watermarking_torch.ops import colorspace, dct
from spread_spectrum_watermarking_tpu.config import Precision as JPrecision
from spread_spectrum_watermarking_tpu.ops import colorspace as jcs
from spread_spectrum_watermarking_tpu.ops import dct as jd

GEOMETRIES = [(64, 96), (96, 64), (37, 59)]
# The kernel's output tile (csrc/wgmma_tile.cuh kRows), its stage depth
# along S (kDepth), and the lanes of the dots' warp (csrc/read_tail.cu).
TILE, DEPTH, LANES = 128, 64, 32


def _pair(seed, h, w, b=2):
    """(derived, base) u8: image 0 a copy of its base changed by at most 3
    steps a channel (as a marked image differs), image 1 unrelated to its
    base (full-range differences)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    near = np.clip(base.astype(int) + rng.integers(-3, 4, base.shape), 0, 255)
    derived = near.astype(np.uint8)
    derived[1:] = rng.integers(0, 256, derived[1:].shape, dtype=np.uint8)
    return torch.from_numpy(derived), torch.from_numpy(base)


def _indices(h, w, n, kind, seed=0, b=2):
    """(b, n) int64 flat indices: distinct random ones, or ``rows``: many in
    a few rows of the shorter axis, with repeats of one index."""
    rng = np.random.default_rng(seed + n)
    if kind == "distinct":
        idx = np.stack([rng.choice(h * w, n, replace=False) for _ in range(b)])
    else:
        land = h <= w
        a = rng.integers(0, min(h, w), (b, n)) % 3      # three short rows
        c = rng.integers(0, max(h, w), (b, n))
        idx = a * w + c if land else c * w + a
        idx[:, n // 2:] = idx[:, :1]                    # one index repeated
    return torch.from_numpy(idx.astype(np.int64))


def _cases():
    for h, w in GEOMETRIES:
        for n in (1, 200, min(h, w) + 13):
            yield h, w, n, "distinct"
        yield h, w, 150, "rows"


CASES = list(_cases())


@jax.jit
def _jax_tail(base, derived, idx):
    h, w = base.shape[-3], base.shape[-2]
    ax = -2 if h <= w else -1
    y = jcs.luma_diff(base, derived)
    td = jd.dct2_pass(y.astype(jnp.bfloat16), axis=ax,
                      precision=JPrecision.DEFAULT, out_dtype=jnp.bfloat16)
    return jd.dct2_dot_at(td, idx, contracted_axis=ax,
                          precision=JPrecision.DEFAULT)


@pytest.mark.parametrize("h,w,n,kind", CASES)
def test_reference_matches_jax_within_k5_bound(h, w, n, kind):
    # The JAX package's read tail (models/pipeline.py:278-288, under jit):
    # its first pass rounded from sums in another order, its dots a masked
    # matmul in another order; k5_bound covers both.
    derived, base = _pair(h * w + n, h, w)
    idx = _indices(h, w, n, kind)
    j = np.array(_jax_tail(jnp.asarray(base.numpy()),
                             jnp.asarray(derived.numpy()),
                             jnp.asarray(idx.numpy(), jnp.int32)))
    t = k5.read_tail_reference(derived, base, idx)
    assert t.shape == (2, n) and t.dtype == torch.float32
    bound = k5.k5_bound(derived, base, idx)
    assert bool(((t.double() - torch.from_numpy(j).double()).abs()
                 <= bound).all())


def _emulate(derived, base, idx, fault=None):
    """The kernel's order of operations in plain torch. The compaction
    (``compact_rows_reference``): each image's distinct rows along S, a
    slot per index. The product at those rows only, padded with zero rows
    to whole 128-row tiles: each 64-deep stage of the first pass summed
    from zero, then added to the f32 sum; each sum rounded to bf16 (D, a
    row per slot). The dot of each index with its slot's row: exact
    products with bf16 C_L over the row padded to whole 128-column tiles;
    lane q of 32 sums its chunks of 8 columns l = 8 (q + 32 k) + e, one sum
    per e with k ascending, then ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6
    + s7)); the lanes are added as the xor shuffles 16, 8, 4, 2, 1 add
    them. Elementwise f32 ops only, so an image's result cannot depend on
    its batch.

    ``fault`` plants a defect a wrong kernel could have: ``"fp8"`` the luma
    operand rounded to fp8 e4m3, ``"row"`` the basis row of the next
    coordinate for every seventh listed row, ``"td"`` the first pass left
    in f32, ``"slot"`` slots 0 and 1 swapped (where an image has one
    distinct row, slot 1 is a zero row of its tile)."""
    h, w = derived.shape[1:3]
    land = h <= w
    s, l = min(h, w), max(h, w)
    y = colorspace.luma_diff(base, derived).to(torch.bfloat16).float()
    if fault == "fp8":
        y = y.to(torch.float8_e4m3fn).float()
    if not land:
        y = y.transpose(-1, -2)                       # (B, S, L)
    idx = idx.expand(derived.shape[0], idx.shape[-1])
    b = idx % w if land else idx // w
    _, rows, slot = k5.compact_rows_reference(idx, h, w, idx.shape[0])
    if fault == "row":
        rows = rows.clone()
        rows[:, ::7] = torch.where(rows[:, ::7] >= 0,
                                   (rows[:, ::7] + 1) % s, -1)
    if fault == "slot":
        slot = torch.where(slot == 0, 1, torch.where(slot == 1, 0, slot))
    cs = dct.basis_tensor(s, derived.device, torch.bfloat16).float()
    cl = dct.basis_tensor(l, derived.device, torch.bfloat16).float()
    pad = -(-rows.shape[-1] // TILE) * TILE - rows.shape[-1]
    a_op = torch.nn.functional.pad(cs[rows.clamp(min=0)] * (
        rows >= 0)[..., None], (0, 0, 0, pad))        # (B, R, S)
    acc = torch.zeros((*a_op.shape[:2], l))
    for k0 in range(0, s, DEPTH):
        part = torch.zeros_like(acc)
        for k in range(k0, min(k0 + DEPTH, s)):
            part = part + a_op[..., k, None] * y[:, None, k, :]
        acc = acc + part
    d = acc if fault == "td" else acc.to(torch.bfloat16).float()
    td = torch.gather(d, 1, slot[..., None].expand(*slot.shape, l))
    prod = td * cl[b]                                 # (B, n, L), exact
    lanes = -(-l // (8 * LANES)) * 8 * LANES
    prod = torch.nn.functional.pad(prod, (0, lanes - l))
    prod = prod.reshape(*idx.shape, -1, LANES, 8)     # l = 8 (32 k + q) + e
    sums = torch.zeros((*idx.shape, LANES, 8))
    for k in range(prod.shape[-3]):
        sums = sums + prod[..., k, :, :]
    v = [sums[..., e] for e in range(8)]
    lane = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]))
    while lane.shape[-1] > 1:
        half = lane.shape[-1] // 2
        lane = lane[..., :half] + lane[..., half:]
    return lane[..., 0]


@pytest.mark.parametrize("h,w,n,kind", CASES)
def test_kernel_order_within_k5_bound_of_reference(h, w, n, kind):
    derived, base = _pair(7 + h + n, h, w)
    idx = _indices(h, w, n, kind, seed=3)
    got = _emulate(derived, base, idx)
    want = k5.read_tail_reference(derived, base, idx)
    bound = k5.k5_bound(derived, base, idx)
    assert bool(((got.double() - want.double()).abs() <= bound).all())
    # Both lie within min(H, W) units of the once-rounded f64 read.
    for out in (got, want):
        assert k5.f64_error(out, derived, base, idx) < min(h, w)
    g = k5.gates(got, derived, base, idx)
    assert g["within_bound"] and g["within_f64"] and g["finite"]


@pytest.mark.parametrize("fault", ["fp8", "row", "td", "slot"])
@pytest.mark.parametrize("h,w,n,kind", CASES)
def test_planted_faults_fail_the_gates(h, w, n, kind, fault):
    # A kernel with one of these defects fails k5_bound or the f64 gate:
    # a wrong basis row or a wrong slot leaves the bound; an fp8 luma
    # leaves it at larger n and fails the f64 gate at all n; a first pass
    # not rounded to bf16 stays within the bound (its errors add with
    # random signs, the bound grows with the length of the dot) and fails
    # the f64 gate.
    derived, base = _pair(7 + h + n, h, w)
    idx = _indices(h, w, n, kind, seed=3)
    g = k5.gates(_emulate(derived, base, idx, fault), derived, base, idx)
    assert not (g["within_bound"] and g["within_f64"])


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_kernel_order_does_not_depend_on_the_batch(h, w):
    # Each image read alone, inside a batch and with a shared index set
    # gives the same bits, and so does a second call.
    derived, base = _pair(11, h, w, b=3)
    idx = _indices(h, w, 120, "distinct", seed=5, b=3)
    batch = _emulate(derived, base, idx)
    assert torch.equal(batch, _emulate(derived, base, idx))
    for i in range(3):
        alone = _emulate(derived[i:i + 1], base[i:i + 1], idx[i:i + 1])
        assert torch.equal(alone[0], batch[i])
    shared = _emulate(derived, base, idx[1])
    assert torch.equal(shared[1], batch[1])


@pytest.mark.parametrize("h,w", GEOMETRIES + [(40, 300)])
def test_kernel_order_does_not_depend_on_the_row_counts(h, w):
    # One batch holds an image whose indices share one row, one whose
    # indices cover min(n, S) rows and a random one; each reads alone what
    # it reads in the batch.
    n = 150
    derived, base = _pair(12, h, w, b=3)
    idx = _indices(h, w, n, "distinct", seed=6, b=3)
    s = min(h, w)
    land = h <= w
    a = np.arange(n) % s
    c = np.arange(n) % max(h, w)
    idx[0] = torch.from_numpy(3 * w + c if land else c * w + 3)
    idx[1] = torch.from_numpy(a * w + c if land else c * w + a)
    count, _, _ = k5.compact_rows_reference(idx, h, w, 3)
    assert count[0] == 1 and count[1] == min(n, s)
    batch = _emulate(derived, base, idx)
    for i in range(3):
        alone = _emulate(derived[i:i + 1], base[i:i + 1], idx[i:i + 1])
        assert torch.equal(alone[0], batch[i])
    g = k5.gates(batch, derived, base, idx)
    assert g["within_bound"] and g["within_f64"] and g["finite"]


@pytest.mark.parametrize("case", ["distinct", "rows", "shared", "n20000"])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_compaction_matches_torch_unique(h, w, case):
    # The compaction's plain version: each image's count of distinct rows,
    # the rows ascending and each index's slot are torch.unique's values,
    # count and inverse, with repeats, one index set for the batch and
    # more indices than rows.
    n = 20000 if case == "n20000" else 200
    kind = "rows" if case == "rows" else "distinct"
    if case == "n20000":
        rng = np.random.default_rng(h + w)
        idx = torch.from_numpy(rng.integers(0, h * w, (2, n)))
    else:
        idx = _indices(h, w, min(n, h * w), kind, seed=8)
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
    derived, base = _pair(2, h, w)
    idx = _indices(h, w, 200, "distinct")
    before = k5.LAUNCHES
    want = k5.read_tail_reference(derived, base, idx)
    assert torch.equal(k5.read_tail(derived, base, idx), want)
    # One index set for the batch reads as that set repeated.
    assert torch.equal(k5.read_tail(derived, base, idx[0]),
                       k5.read_tail_reference(derived, base,
                                              idx[0].expand(2, -1)))
    assert k5.LAUNCHES == before
    # The reference is K1's pair mode and the DEFAULT gather-dot.
    td = luma_pass_reference(derived, base)
    assert torch.equal(want, dct.dct2_dot_at(
        td, idx, contracted_axis=dct.shorter_axis(h, w),
        precision=Precision.DEFAULT))


@pytest.mark.parametrize("bad", ["float_images", "shapes", "idx_dtype",
                                 "idx_batch", "idx_rank", "idx_low",
                                 "idx_high", "channels"])
def test_argument_checks_raise(bad):
    derived, base = _pair(3, 37, 59)
    idx = _indices(37, 59, 20, "distinct")
    if bad == "float_images":
        derived = derived.float()
    elif bad == "shapes":
        base = base[:, :36]
    elif bad == "idx_dtype":
        idx = idx.int()
    elif bad == "idx_batch":
        idx = idx[:1]
    elif bad == "idx_rank":
        idx = idx[None]
    elif bad == "idx_low":
        idx[0, 3] = -1
    elif bad == "idx_high":
        idx[1, 0] = 37 * 59
    else:
        derived, base = derived[..., :2], base[..., :2]
    with pytest.raises(ValueError):
        k5.read_tail(derived, base, idx)


@pytest.mark.parametrize("method", [Method.OPTION1, Method.OPTION2,
                                    Method.OPTION3])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_extract_fast_tail_on_the_cpu_is_the_plain_route(h, w, method):
    # The read tail on the CPU is, bit for bit, K1's pair mode, the DEFAULT
    # gather-dot and the extraction equation, as before K5.
    derived, base = _pair(9, h, w)
    idx = _indices(h, w, 150, "distinct", seed=2)
    base_vals = torch.from_numpy(np.random.default_rng(4).uniform(
        20.0, 500.0, (2, 150)).astype(np.float32))
    cfg = ReadConfig(extraction=InsertExtract(method=method, alpha=0.1),
                     precision=Precision.DEFAULT)
    got = tp._extract_fast_tail(base, derived, idx, base_vals, cfg)
    num = dct.dct2_dot_at(luma_pass_reference(derived, base), idx,
                          contracted_axis=dct.shorter_axis(h, w),
                          precision=Precision.DEFAULT)
    if method == Method.OPTION1:
        want = num / 0.1
    elif method == Method.OPTION2:
        want = num / (base_vals * 0.1)
    else:
        want = torch.log1p(num / base_vals) / 0.1
    # Bit for bit; Option3 reads NaN where the unrelated image's delta
    # falls below -base (the log of a negative ratio), in both.
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
