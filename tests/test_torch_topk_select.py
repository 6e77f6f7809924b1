"""K3 (``kernels/topk_select.py``): its plain versions on the CPU.

- (A) ``top_by_key``'s plain version against ``np.lexsort((pos, -key))``,
  the contract (key desc, pos asc), on the cases a radix select can get
  wrong: int32 keys over the whole range, negative f32 total-order keys
  among them, a row of equal keys, L not a multiple of a block's tile,
  n = 1 and n = L, leading batch dimensions, and positions that are not an
  arange (shared, or per row).
- The same contract for the kernel's two algorithms, emulated here in
  numpy: the multi-pass path (n > ``CAP``: 11-bit digits from the top of
  the composite, the stop rule and the compaction, then the sort of the
  candidates) and the two-stage path (n <= ``CAP``: each chunk streamed in
  tiles through a bounded buffer with a running bound, cut by 8-bit radix
  selects to between n and n + slack entries, at most n + slack candidates
  a chunk, the same over the row's candidates with an exact last cut,
  then the sort), over chunk sizes, slacks and tie-heavy inputs.
- Generation 2's plain version (``top_of_plane_reference``: the set, the
  estimates and the re-sort) bit for bit equal to the chain of plain ops
  ``approx_top_indices`` ran before the re-sort moved into K3.
- The f32 mode's plain version (``top_of_coeffs_reference``) index for
  index equal to ``ranking.top_indices`` and to the JAX package's.
- (B) ``plane_keys`` bit for bit against the JAX package's key build
  (``ops/ranking.py:256-273``, through ``jax.lax.bitcast_convert_type``) on
  one bf16 plane with DC and signed zeros, at each ordering, and against
  the kernel's key build emulated in numpy, whose ENERGY_ORTHOGONAL scale
  is recomputed from (row, column) and must equal ``_flat_scale(h, w)``
  rounded to bf16 at the sizes the pipelines use.
- HIGHEST's single select (the card's route for ENERGY and
  ENERGY_ORTHOGONAL) equal to the tiled route and to JAX's ``top_indices``
  on ``test_torch_top_indices.py``'s branches, with planted ties.
- CPU tensors leave K3's launch counts at 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_tpu.config import Ordering as JOrdering
from spread_spectrum_watermarking_tpu.ops import ranking as jr
from spread_spectrum_watermarking_torch import kernels
from spread_spectrum_watermarking_torch.config import Ordering
from spread_spectrum_watermarking_torch.kernels import topk_select as k3
from spread_spectrum_watermarking_torch.ops import ranking as tr

ORDERINGS = ["energy", "energy-orthogonal", "legacy"]
I32 = np.iinfo(np.int32)


def _f32_total_order(x):
    """f32 -> int32 in IEEE total order, as ``ranking._f32_key``."""
    bits = x.astype(np.float32).view(np.int32)
    return np.where(bits < 0, bits ^ 0x7FFFFFFF, bits).astype(np.int32)


def _case(name, rng):
    """(key (..., L) int32, pos None / (L,) / (..., L) int64, n)."""
    if name == "full_range":
        key = rng.integers(I32.min, I32.max, (3, 5000), endpoint=True)
        return key.astype(np.int32), None, 300
    if name == "f32_total_order":  # negative keys, -0.0 below +0.0
        x = rng.standard_normal((2, 4099)).astype(np.float32)
        x[:, ::7] = -0.0
        x[:, 1::7] = 0.0
        return _f32_total_order(x), None, 2500
    if name == "extremes":
        vals = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1,
                         I32.max], np.int32)
        return vals[rng.integers(0, 7, (2, 3001))], None, 1000
    if name == "equal_row":
        return np.full((2, 5000), 7, np.int32), None, 2000
    if name == "equal_row_permuted_pos":
        pos = np.stack([rng.permutation(5000) for _ in range(2)])
        return np.full((2, 5000), -3, np.int32), pos * 1000 + 11, 1500
    if name == "ragged_length":
        return rng.integers(-50, 50, (2, 1001)).astype(np.int32), None, 77
    if name == "n_is_one":
        return rng.integers(-5, 5, (4, 777)).astype(np.int32), None, 1
    if name == "n_is_length":
        return rng.integers(-5, 5, (4, 777)).astype(np.int32), None, 777
    if name == "batch_dims":
        key = rng.integers(-20, 20, (2, 3, 2048)).astype(np.int32)
        return key, None, 100
    if name == "shared_pos":  # tile-ordered candidates: not an arange
        return (rng.integers(0, 9, (3, 4096)).astype(np.int32),
                rng.permutation(2 ** 31 - 1 - np.arange(4096)), 500)
    if name == "per_row_pos":  # the re-sort: the selected flat indices
        pos = np.stack([rng.choice(2 ** 31 - 1, 1000, replace=False)
                        for _ in range(6)]).reshape(2, 3, 1000)
        return rng.integers(0, 30, (2, 3, 1000)).astype(np.int32), pos, 1000
    raise KeyError(name)


CASES = ["full_range", "f32_total_order", "extremes", "equal_row",
         "equal_row_permuted_pos", "ragged_length", "n_is_one",
         "n_is_length", "batch_dims", "shared_pos", "per_row_pos"]


def _lexsort_top(key, pos, n):
    """The contract: per row, the first n of (key desc, pos asc)."""
    flat = key.reshape(-1, key.shape[-1]).astype(np.int64)
    if pos is None:
        pos = np.arange(key.shape[-1])
    pos = np.broadcast_to(pos, key.shape).reshape(flat.shape)
    out = np.stack([np.lexsort((p, -k))[:n] for k, p in zip(flat, pos)])
    return out.reshape(*key.shape[:-1], n)


@pytest.mark.parametrize("name", CASES)
def test_top_by_key_plain_version_is_the_lexsort_order(name):
    key, pos, n = _case(name, np.random.default_rng(CASES.index(name)))
    tpos = None if pos is None else torch.from_numpy(np.array(pos))
    got = k3.top_by_key(torch.from_numpy(key), tpos, n).numpy()
    np.testing.assert_array_equal(got, _lexsort_top(key, pos, n))
    np.testing.assert_array_equal(
        got, k3.top_by_key_reference(torch.from_numpy(key), tpos, n).numpy())


def _mapped(key, key_bits):
    """The kernel's unsigned keys: int32 with the sign bit flipped (32
    bits), or a plane key + 0x8000 with DC at 0 (16 bits)."""
    if key_bits == 32:
        return key.astype(np.int64) & 0xFFFFFFFF ^ 0x80000000
    return np.where(key == tr._DC_KEY, 0, key.astype(np.int64) + 0x8000)


def _composites(k, t, pbits):
    """(k << pbits) | (2^pbits - 1 - t) as uint64."""
    return (k.astype(np.uint64) << np.uint64(pbits)) | (
        np.uint64((1 << pbits) - 1) - t.astype(np.uint64))


def _emulated_select(key, pos, n, key_bits=32):
    """The multi-pass path in numpy, on one row: each element's composite
    (k << pbits) | (2^pbits - 1 - pos), 11-bit digits from the top while
    the candidates do not fit the sort, then the compaction (composite >=
    prefix) and a descending sort of the candidates."""
    length = key.shape[-1]
    k = _mapped(key, key_bits)
    pbits = 31 if pos is not None else int(length - 1).bit_length()
    p = np.arange(length) if pos is None else pos
    u = _composites(k, np.asarray(p), pbits)
    cap = min(16384, max(2048, 2 * n)) if n <= 16384 else n
    lo, prefix, above = key_bits + pbits, 0, 0
    passes = 0
    while length > cap and lo > 0:
        d = min(11, lo)
        sh = lo - d
        inb = (u >> np.uint64(lo)) == np.uint64(prefix >> lo)
        digits = ((u[inb] >> np.uint64(sh)) & np.uint64((1 << d) - 1))
        hist = np.bincount(digits.astype(np.int64), minlength=1 << d)
        need, acc = n - above, 0
        for b in range(len(hist) - 1, -1, -1):
            if acc + hist[b] >= need:
                break
            acc += hist[b]
        above += acc
        prefix |= b << sh
        lo = sh
        passes += 1
        if above + hist[b] <= cap:
            break
    cand = np.nonzero(u >= np.uint64(prefix))[0]
    assert n <= len(cand) <= max(cap, n) or length <= cap
    order = cand[np.argsort(u[cand])[::-1]]
    return order[:n], passes


@pytest.mark.parametrize("name", ["full_range", "f32_total_order",
                                  "equal_row", "equal_row_permuted_pos",
                                  "n_is_one", "shared_pos"])
def test_emulated_radix_select_is_the_lexsort_order(name):
    key, pos, n = _case(name, np.random.default_rng(CASES.index(name)))
    rng = np.random.default_rng(5)
    # Rows longer than the sort's 2048 slots, so that the passes run.
    key = np.concatenate([key.reshape(-1, key.shape[-1])[:1]] * 3, -1)
    if pos is not None:
        pos = np.arange(key.shape[-1]) * 7 + rng.integers(0, 7)
        pos = rng.permutation(pos)
    want = _lexsort_top(key, pos, n)[0]
    got, passes = _emulated_select(key[0], pos, n)
    np.testing.assert_array_equal(got, want)
    assert passes >= 1


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_emulated_plane_select_matches_the_plain_version(ordering):
    # 16-bit keys (DC mapped below them), positions along the row; the
    # multi-pass path and the two-stage path.
    plane = _signed_zero_plane(11, 2, 48, 64)
    keys = k3.plane_keys(plane, Ordering(ordering)).numpy()
    idx, kv = k3.plane_set_reference(plane, 300, Ordering(ordering))
    for b in range(2):
        got, passes = _emulated_select(keys[b], None, 300, key_bits=16)
        np.testing.assert_array_equal(got, idx[b].numpy())
        assert passes >= 1
        got = _emulated_two_stage(keys[b], None, 300, chunk=1024, tile=256,
                                  buf=1024, key_bits=16, slack=200)
        np.testing.assert_array_equal(got, idx[b].numpy())
    np.testing.assert_array_equal(kv.numpy(),
                                  np.take_along_axis(keys, idx.numpy(), -1))


def _radix_bound(comp, m, lo0, m_hi=None):
    """The kernel's ``select_bound``: 8-bit digits of the composites from
    bit lo0 down, until the bucket of the m-th largest fits under m_hi
    (None: m, exact); the bound P with between m and m_hi composites at or
    above it."""
    m_hi = m if m_hi is None else m_hi
    prefix, lo, above = 0, lo0, 0
    while True:
        d = min(8, lo)
        sh = lo - d
        inb = (comp >> np.uint64(lo)) == np.uint64(prefix >> lo)
        digits = (comp[inb] >> np.uint64(sh)) & np.uint64((1 << d) - 1)
        hist = np.bincount(digits.astype(np.int64), minlength=256)
        need, acc = m - above, 0
        for b in range(255, -1, -1):
            if acc + hist[b] >= need:
                break
            acc += hist[b]
        prefix |= b << sh
        lo = sh
        above += acc
        if above + hist[b] <= m_hi or sh == 0:
            assert m <= int((comp >= np.uint64(prefix)).sum()) <= m_hi
            return prefix


def _bounded(k, t, j, n, keep, last, tile, buf, lo0, pbits):
    """One block of the two-stage path: (k, t, j) streamed in tiles, each
    element at or above the running bound P appended to a buffer of
    ``buf`` entries; once the buffer could not take another tile it is cut
    to between n and ``keep`` of its best (``_radix_bound``) and P rises;
    at the end, cut again if more than ``last`` are left (to exactly n
    when ``last`` is n). Returns the kept (k, t, j), in no particular
    order."""
    bk = np.zeros(0, np.int64)
    bt = bj = bk
    bound = 0
    for s in range(0, len(k), tile):
        c = _composites(k[s:s + tile], t[s:s + tile], pbits)
        at = c >= np.uint64(bound)
        bk = np.concatenate([bk, k[s:s + tile][at]])
        bt = np.concatenate([bt, t[s:s + tile][at]])
        bj = np.concatenate([bj, j[s:s + tile][at]])
        assert len(bk) <= buf
        if len(bk) >= buf - tile:
            bound = _radix_bound(_composites(bk, bt, pbits), n, lo0, keep)
            kept = _composites(bk, bt, pbits) >= np.uint64(bound)
            bk, bt, bj = bk[kept], bt[kept], bj[kept]
    if len(bk) > last:
        bound = _radix_bound(_composites(bk, bt, pbits), n, lo0,
                             keep if last == keep else n)
        kept = _composites(bk, bt, pbits) >= np.uint64(bound)
        bk, bt, bj = bk[kept], bt[kept], bj[kept]
    assert min(n, len(k)) <= len(bk) <= last
    return bk, bt, bj


def _emulated_two_stage(key, pos, n, chunk, tile, buf, key_bits=32,
                        slack=0):
    """The two-stage path in numpy, on one row: each chunk of ``chunk``
    elements down to at most n + ``slack`` candidates that hold its top n
    (``_bounded``), then the row's candidates the same way, the last cut
    exact, sorted by composite."""
    length = key.shape[-1]
    k = _mapped(key, key_bits)
    pbits = 31 if pos is not None else int(length - 1).bit_length()
    j = np.arange(length)
    t = j if pos is None else np.asarray(pos)
    lo0 = key_bits + pbits
    keep = n + min(slack, buf - tile - n)
    parts = [_bounded(k[c:c + chunk], t[c:c + chunk], j[c:c + chunk], n,
                      keep, keep, tile, buf, lo0, pbits)
             for c in range(0, length, chunk)]
    ck, ct, cj = (np.concatenate(a) for a in zip(*parts))
    fk, ft, fj = _bounded(ck, ct, cj, n, keep, n, min(tile, 2048), buf, lo0,
                          pbits)
    order = np.argsort(_composites(fk, ft, pbits))[::-1]
    return fj[order]


def _two_stage_case(name, rng):
    """(key (L,) int32, pos None / (L,) int64, n): tie-heavy rows."""
    i32 = np.iinfo(np.int32)
    if name == "all_equal":
        return np.full(3000, 5, np.int32), None, 100
    if name == "all_equal_pos":
        return np.full(3000, -9, np.int32), \
            rng.permutation(3000).astype(np.int64) * 5 + 3, 100
    if name == "runs_across_chunks":  # equal runs of 333 straddle borders
        return np.repeat(rng.integers(-3, 3, 10), 333).astype(np.int32), \
            None, 150
    if name == "short_chunks":  # fewer elements a chunk than n
        return rng.integers(-4, 4, 700).astype(np.int32), None, 180
    if name == "int32_extremes":
        vals = np.array([i32.min, i32.min + 1, -1, 0, 1, i32.max - 1,
                         i32.max], np.int32)
        return vals[rng.integers(0, 7, 2900)], None, 120
    if name == "ascending":  # every element raises the bound
        return np.arange(-1500, 1500).astype(np.int32), None, 90
    raise KeyError(name)


TWO_STAGE = ["all_equal", "all_equal_pos", "runs_across_chunks",
             "short_chunks", "int32_extremes", "ascending"]


@pytest.mark.parametrize("slack", [0, 17])
@pytest.mark.parametrize("chunk", [64, 128, 1000])
@pytest.mark.parametrize("name", TWO_STAGE)
def test_emulated_two_stage_select_is_the_plain_version(name, chunk, slack):
    key, pos, n = _two_stage_case(name, np.random.default_rng(
        TWO_STAGE.index(name)))
    want = k3.top_by_key_reference(
        torch.from_numpy(key), None if pos is None else torch.from_numpy(pos),
        n).numpy()
    np.testing.assert_array_equal(want, _lexsort_top(key, pos, n))
    # Tiles of 32 and a buffer of 256: cuts happen every few tiles.
    got = _emulated_two_stage(key, pos, n, chunk=chunk, tile=32, buf=256,
                              slack=slack)
    np.testing.assert_array_equal(got, want)


def _pre_fusion_chain(plane, n, ordering):
    """``ops/ranking.approx_top_indices``'s generation-2 branch before its
    re-sort moved into K3, verbatim on the plain versions: the set by the
    full key, the estimates rebuilt from the keys, then the re-sort."""
    key = k3.plane_keys(plane, ordering)
    idx = k3.top_by_key_reference(key, None, n)
    kv = torch.gather(key, -1, idx)
    h, w = plane.shape[-2], plane.shape[-1]
    if ordering == Ordering.LEGACY:
        order_key = kv
        bits = torch.where(kv < 0, (-kv) | 0x8000, kv)
        sval = bits.to(torch.int16).view(torch.bfloat16).to(torch.float32)
    else:
        mag_bits = kv & 0xFFFE
        order_key = mag_bits
        mag = mag_bits.to(torch.int16).view(torch.bfloat16).to(torch.float32)
        sval = torch.where((kv & 1) != 0, -mag, mag)
    order_key = torch.where(idx == 0, tr._DC_KEY, order_key)
    sval = torch.where(idx == 0, 0.0, sval)
    if ordering == Ordering.ENERGY:
        cand_c = sval
    else:
        cand_c = sval / tr._flat_scale(h, w, idx.device)[idx]
    resort = tr._top_by_key(order_key, idx, n)
    return torch.gather(idx, -1, resort), torch.gather(cand_c, -1, resort)


@pytest.mark.parametrize("n", [1, 300, 48 * 64])
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_generation2_plain_version_is_the_pre_fusion_chain(ordering, n):
    plane = _signed_zero_plane(21, 2, 48, 64)
    o = Ordering(ordering)
    idx, est = k3.top_of_plane_reference(plane, n, o)
    want_idx, want_est = _pre_fusion_chain(plane, n, o)
    np.testing.assert_array_equal(idx.numpy(), want_idx.numpy())
    # Bit for bit, signed zeros included.
    np.testing.assert_array_equal(est.numpy().view(np.int32),
                                  want_est.numpy().view(np.int32))
    got_idx, got_est = tr.approx_top_indices(plane, n, o)
    assert torch.equal(got_idx, idx)
    np.testing.assert_array_equal(got_est.numpy().view(np.int32),
                                  est.numpy().view(np.int32))


def _signed_zero_plane(seed, b, h, w):
    """A bf16 plane with quarter-step ties, both signed zeros and a large
    DC."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((b, h, w)) * 8) / 4
    m = rng.random((b, h, w))
    x[m < 0.1] = 0.0
    x[(m >= 0.1) & (m < 0.2)] = -0.0
    x[:, 0, 0] = 1e4
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@jax.jit
def _jax_keys_energy(flat_c):
    a = jnp.abs(flat_c).astype(jnp.bfloat16)
    au = jax.lax.bitcast_convert_type(a, jnp.uint16)
    sgn = jnp.signbit(flat_c).astype(jnp.uint16)
    return (au & jnp.uint16(0xFFFE)) | sgn


def _jax_keys(plane, ordering):
    """The JAX package's generation-2 keys (``ranking.py:256-273``) of a
    (B, H, W) bf16 plane as signed ints in their order; DC as JAX's -inf
    key."""
    b, h, w = plane.shape
    flat_c = jnp.asarray(plane.float().numpy(), jnp.bfloat16).reshape(
        b, h * w)
    if ordering != "energy":
        scale = jnp.asarray(jr._ortho_scale_map(h, w)).reshape(h * w)
        flat_c = jax.jit(lambda c, s: c * s.astype(c.dtype))(flat_c, scale)
    if ordering == "legacy":
        bits = np.asarray(jax.lax.bitcast_convert_type(
            flat_c.astype(jnp.bfloat16), jnp.uint16)).astype(np.int64)
        mag = bits & 0x7FFF
        keys = np.where(bits >= 0x8000, -mag, mag)
    else:
        keys = np.asarray(_jax_keys_energy(flat_c)).astype(np.int64)
    keys[:, 0] = tr._DC_KEY
    return keys


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_plane_keys_bit_equal_to_jax(ordering):
    plane = _signed_zero_plane(3, 2, 37, 59)
    assert (plane == 0).any() and torch.signbit(plane[plane == 0]).any()
    got = k3.plane_keys(plane, Ordering(ordering)).numpy()
    np.testing.assert_array_equal(got, _jax_keys(plane, ordering))
    assert (got[:, 0] == tr._DC_KEY).all() and (got[:, 1:] > tr._DC_KEY).all()


def _bf16_rne(x):
    """f32 -> bf16 bits, round to nearest even (finite values)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _kernel_scale_bits(h, w):
    """The kernel's ENERGY_ORTHOGONAL scale at every (r, c), emulated: the
    f32 product of the row's and the column's factor, rounded to bf16."""
    s_k0_w, s_w, s_k0_h, s_h = k3.scale_factors(h, w)
    row = np.where(np.arange(h) == 0, s_k0_w, s_w).astype(np.float32)
    col = np.where(np.arange(w) == 0, s_k0_h, s_h).astype(np.float32)
    return _bf16_rne(row[:, None] * col[None, :]).reshape(-1)


@pytest.mark.parametrize("h,w", [(37, 59), (444, 640), (1080, 1920),
                                 (2160, 3840)])
def test_recomputed_ortho_scale_equals_the_flat_scale(h, w):
    want = tr._flat_scale(h, w, torch.device("cpu")).to(torch.bfloat16)
    np.testing.assert_array_equal(_kernel_scale_bits(h, w),
                                  want.view(torch.int16).numpy()
                                  .view(np.uint16))


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_emulated_kernel_key_build_is_the_plain_key_build(ordering):
    # The kernel's arithmetic on one element: v * bf16(s) in f32 (exact),
    # rounded once to bf16, then the key of the ordering; DC below all.
    b, h, w = 2, 37, 59
    plane = _signed_zero_plane(9, b, h, w)
    bits = plane.view(torch.int16).numpy().view(np.uint16).reshape(b, -1)
    if ordering != "energy":
        sbits = _kernel_scale_bits(h, w).astype(np.uint32) << 16
        v = (bits.astype(np.uint32) << 16).view(np.float32)
        bits = _bf16_rne(v * sbits.view(np.float32))
    bits = bits.astype(np.int64)
    if ordering == "legacy":
        mag = bits & 0x7FFF
        keys = np.where(bits & 0x8000, -mag, mag)
    else:
        keys = (bits & 0x7FFE) | (bits >> 15)
    keys[:, 0] = -0x8001
    np.testing.assert_array_equal(
        keys, k3.plane_keys(plane, Ordering(ordering)).numpy())


def _planted(seed, h, w):
    """Quarter-step values (ties), 30% zeros of both signs
    (``test_torch_top_indices._planted``)."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((2, h, w)) * 4) / 4
    m = rng.random((2, h, w))
    x[m < 0.15] = 0.0
    x[(m >= 0.15) & (m < 0.3)] = -0.0
    return x.astype(np.float32)


# test_torch_top_indices.py's branches: the small one, the tiled one and
# the tiled one recursing over its tile maxima.
BRANCHES = [(37, 59, 50), (64, 96, 20), (200, 180, 30)]
_jax_top = jax.jit(jr.top_indices, static_argnums=(1, 2, 3, 4))


@pytest.mark.parametrize("h,w,n", BRANCHES)
@pytest.mark.parametrize("ordering", ["energy", "energy-orthogonal"])
def test_single_select_is_the_tiled_route_and_jax(h, w, n, ordering):
    plane = _planted(h + w + n, h, w)
    metric = tr.ranking_metric(torch.from_numpy(plane), Ordering(ordering))
    key = tr._f32_key(metric.reshape(2, h * w).contiguous())
    key[..., 0] = tr._NEG_INF_KEY
    single = tr._top_by_key(key, None, n).numpy()
    tiled = tr._tiled_top(key, n, 32).numpy()
    want = np.asarray(_jax_top(jnp.asarray(plane), n, JOrdering(ordering),
                               False))
    np.testing.assert_array_equal(single, want)
    np.testing.assert_array_equal(tiled, want)
    # The planted plane has ties at the boundary, which the select breaks
    # by index as the tiled route does.
    vals = np.take_along_axis(metric.reshape(2, -1).numpy(), single, -1)
    assert (np.diff(vals, axis=-1) == 0).any()


@pytest.mark.parametrize("n", [50, 200])
@pytest.mark.parametrize("h,w", [(37, 59), (64, 96)])
@pytest.mark.parametrize("ordering", ["energy", "energy-orthogonal"])
def test_coeff_mode_plain_version_is_top_indices_and_jax(ordering, h, w, n):
    for plane in (_planted(h * w + n, h, w),
                  np.random.default_rng(n).standard_normal(
                      (2, h, w)).astype(np.float32)):
        got = k3.top_of_coeffs_reference(torch.from_numpy(plane), n,
                                         Ordering(ordering)).numpy()
        np.testing.assert_array_equal(
            got, tr.top_indices(torch.from_numpy(plane), n,
                                Ordering(ordering)).numpy())
        np.testing.assert_array_equal(
            got, np.asarray(_jax_top(jnp.asarray(plane), n,
                                     JOrdering(ordering), False)))
        assert not (got == 0).any()


def test_cpu_tensors_leave_k3_uncounted():
    kernels.reset_launch_counts()
    plane = _signed_zero_plane(4, 2, 48, 64)
    for version in (1, 2):
        tr.approx_top_indices(plane, 100, Ordering.ENERGY, version=version)
    tr.top_indices(plane.float(), 30, Ordering.ENERGY)
    tr.top_indices(plane.float(), 30, Ordering.LEGACY)
    k3.top_by_key(torch.zeros(3, 10, dtype=torch.int32), None, 4)
    k3.top_of_plane(plane, 5, Ordering.LEGACY)
    k3.top_of_coeffs(plane.float(), 5, Ordering.ENERGY)
    counts = kernels.launch_counts()
    assert counts["k3"] == counts["k3_plane"] == counts["k3_coeffs"] == 0
