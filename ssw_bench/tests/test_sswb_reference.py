"""The plain reference: its transforms against scipy, its rounding, its
ranking rules, and its inverse against a dense inverse."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.fft
import torch

from ssw_bench import reference as R


def _plane(seed, h=24, w=40):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((h, w), generator=g, dtype=torch.float64)


def test_dct_matches_scipy_ortho():
    y = _plane(0)
    h, w = y.shape
    c = R.dct_basis(h, "cpu") @ y @ R.dct_basis(w, "cpu").T
    # scipy's ortho scaling of the unnormalized DCT-II.
    sh = np.full(h, np.sqrt(1 / (2 * h)))
    sh[0] = np.sqrt(1 / (4 * h))
    sw = np.full(w, np.sqrt(1 / (2 * w)))
    sw[0] = np.sqrt(1 / (4 * w))
    ortho = c.numpy() * sh[:, None] * sw[None, :]
    np.testing.assert_allclose(
        ortho, scipy.fft.dctn(y.numpy(), type=2, norm="ortho"), atol=1e-12)
    np.testing.assert_allclose(c.numpy(), scipy.fft.dctn(y.numpy(), type=2),
                               atol=1e-11)


def test_inverse_undoes_the_forward():
    y = _plane(1)
    h, w = y.shape
    c = R.dct_basis(h, "cpu") @ y @ R.dct_basis(w, "cpu").T
    back = (R.idct_basis(h, "cpu") @ c @ R.idct_basis(w, "cpu").T) \
        * (4.0 / (h * w))
    torch.testing.assert_close(back, y, atol=1e-12, rtol=0)


def test_round_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, -3.1, 0.0],
                     dtype=torch.float64)
    got = R.round_bits(x, 8)
    want = torch.tensor([1.0, 1.0, 1.0 + 2 ** -7, -3.09375, 0.0],
                        dtype=torch.float64)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # bf16's rounding of float32 values, ties to even.
    v = torch.randn(10000, dtype=torch.float32)
    torch.testing.assert_close(R.round_bits(v.double(), 8),
                               v.to(torch.bfloat16).double(), atol=0, rtol=0)
    torch.testing.assert_close(R.round_bits(v.double(), 24), v.double(),
                               atol=0, rtol=0)


def test_sparse_inverse_equals_dense_inverse():
    h, w, n = 16, 24, 30
    g = torch.Generator().manual_seed(2)
    idx = torch.randperm(h * w, generator=g)[:n][None]
    delta = torch.randn((1, n), generator=g, dtype=torch.float64)
    dense = torch.zeros(h * w, dtype=torch.float64)
    dense[idx[0]] = delta[0]
    full = (R.idct_basis(h, "cpu") @ dense.reshape(h, w)
            @ R.idct_basis(w, "cpu").T) * (4.0 / (h * w))
    for tier in ("default", "highest"):
        got = R.inverse(delta, idx, h, w, tier, None)
        torch.testing.assert_close(got[0], full, atol=1e-12, rtol=0)


def test_highest_rank_is_energy_with_index_ties():
    plane = torch.tensor([[100.0, 3.0, -5.0], [5.0, 0.5, -3.0]],
                         dtype=torch.float64)[None]
    idx, vals = R.rank(plane, "highest", 4)
    # DC (index 0) never ahead; ties of |v| by index.
    assert idx.tolist() == [[2, 3, 1, 5]]
    assert vals.tolist() == [[-5.0, 5.0, 3.0, -3.0]]


def test_default_rank_keys_and_estimates():
    vals = torch.tensor([9.0, 1.0 + 2 ** -7, 1.0, -1.0, 2.0, -0.5],
                        dtype=torch.float64)
    idx, est = R.rank(vals.reshape(1, 2, 3), "default", 4)
    # 2.0 first; 1 + 2^-7 and 1.0 share their magnitude bits once the last
    # bit is cleared, so index order; -1.0's key carries its sign bit and
    # ranks above +1.0's in the select, but the order ignores the sign.
    assert idx.tolist() == [[4, 1, 2, 3]]
    assert est.tolist() == [[2.0, 1.0, 1.0, -1.0]]


def test_embed_then_read_recovers_the_mark():
    g = torch.Generator().manual_seed(4)
    rgb = torch.randint(0, 256, (2, 32, 48, 3), generator=g,
                        dtype=torch.uint8)
    marks = torch.randn((2, 40), generator=g)
    for tier in ("default", "highest"):
        bits = R.TIER_BITS[tier]
        marked, idx, vals = R.embed(rgb, marks, tier, 40, 0.1, bits)
        ext = R.read(rgb, marked, idx, vals, 0.1, tier, bits)
        sim = R.similarity(ext, marks.double()).diagonal()
        assert (sim > 4).all(), (tier, sim)


@pytest.mark.parametrize("tier", ["default", "highest"])
def test_control_is_coarser_than_the_tier(tier):
    g = torch.Generator().manual_seed(5)
    rgb = torch.randint(0, 256, (1, 32, 48, 3), generator=g,
                        dtype=torch.uint8)
    exact = R.forward(rgb, "default", 53)   # float64, no rounding

    def rms(bits):
        return (R.forward(rgb, tier, bits) - exact).pow(2).mean().sqrt()

    assert rms(R.CONTROL_BITS[tier]) > 4 * rms(R.TIER_BITS[tier])
