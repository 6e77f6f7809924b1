"""The port's sharded DCT and distributed top-k against the JAX package's.

The port runs in 4 gloo ranks on the CPU (spawned once for the module by
``parallel.launch.run_ranks``, mesh (1, 4)); the JAX package on 4 of the
test process's virtual CPU devices, mesh (1, 4). Same seeded numpy inputs.
Bounds are the JAX suite's own (tests/test_sharded.py): coefficients within
rtol 1e-5, atol 1e-4 of the exact (f64 scipy) transform, as JAX's sharded
result is too, and within the port's cross-package bound of JAX's
(tests/test_torch_dct_highest.py: two f32 sums in other orders; the two
f32 results differ by up to twice each one's error, so rtol 1e-5, atol
1e-4 cannot hold between them); the round trip within atol 1e-4 and
within rtol 1e-5, atol 1e-4 of JAX's; the top-k indices equal, for each
ordering and on the equal-metric tie construction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
from jax import shard_map
from jax.sharding import PartitionSpec as P

from spread_spectrum_watermarking_torch.parallel.dryrun import parity_rank
from spread_spectrum_watermarking_torch.parallel.launch import run_ranks
from spread_spectrum_watermarking_tpu.config import Ordering
from spread_spectrum_watermarking_tpu.ops import dct as jdct
from spread_spectrum_watermarking_tpu.ops import ranking as jranking
from spread_spectrum_watermarking_tpu.parallel import dct_sharded as jds
from spread_spectrum_watermarking_tpu.parallel import make_mesh
from spread_spectrum_watermarking_tpu.parallel.mesh import SPATIAL_AXIS
from spread_spectrum_watermarking_tpu.parallel.topk_sharded import (
    distributed_top_indices,
)

SHAPES = [(64, 96), (66, 98)]  # divisible by the 4 ranks, and not
ORDERINGS = list(Ordering)
N = 50


def _plane(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _gamma_bound(y):
    """2 (H + W) 2^-24 |C_h| |Y| |C_w|^T, in f64."""
    h, w = y.shape
    a = np.abs(jdct.dct2_basis(h).astype(np.float64)) @ \
        np.abs(y.astype(np.float64)) @ \
        np.abs(jdct.dct2_basis(w).astype(np.float64)).T
    return 2 * (h + w) * 2.0 ** -24 * a


def _tie_plane():
    # Equal metrics on different ranks: the lower global index must win.
    c = np.zeros((8, 64), np.float32)
    c[0, 5] = 2.0    # rank 0
    c[0, 60] = -2.0  # rank 3, equal energy, higher index
    c[3, 10] = 2.0   # rank 0, equal energy, higher index
    return c


@pytest.fixture(scope="module")
def jax_mesh():
    return make_mesh((1, 4), devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def port():
    topk = [(_plane((32, 64), 2), N, o.value) for o in ORDERINGS]
    topk += [(_plane((34, 66), 3), N, o.value) for o in ORDERINGS]
    topk.append((_tie_plane(), 3, Ordering.ENERGY.value))
    cases = {
        "dct": {"shape": (1, 4),
                "planes": [_plane(s, i) for i, s in enumerate(SHAPES)]},
        "topk": {"shape": (1, 4), "cases": topk},
    }
    return run_ranks(parity_rank, 4, device="cpu", timeout=240,
                     args=(cases, "cpu"))


def _jax_topk(coeffs, n, ordering, mesh):
    h, w = coeffs.shape
    return np.asarray(shard_map(
        lambda blk: distributed_top_indices(blk, n, ordering, h, w),
        mesh=mesh, in_specs=P(None, SPATIAL_AXIS), out_specs=P(None),
    )(jnp.asarray(coeffs)))


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_sharded_dct_matches_jax(port, jax_mesh, i):
    y = _plane(SHAPES[i], i)
    exact = scipy.fft.dctn(y.astype(np.float64), type=2)
    want = np.asarray(jds.dct2_2d_sharded(jnp.asarray(y), jax_mesh))
    np.testing.assert_allclose(want, exact, rtol=1e-5, atol=1e-4)
    for rank in port:  # the gathered result, on every rank
        got = rank["dct"][i]["coeffs"]
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)
        # Against JAX's f32 result, element by element: two f32 sums of H
        # and W terms taken in other orders (tests/test_torch_dct_highest).
        bound = _gamma_bound(y)
        assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_sharded_idct_round_trip_matches_jax(port, jax_mesh, i):
    y = _plane(SHAPES[i], i)
    back = port[0]["dct"][i]["back"]
    assert back.shape == y.shape
    np.testing.assert_allclose(back, y, atol=1e-4)
    coeffs = jds.dct2_2d_sharded(jnp.asarray(y), jax_mesh)
    want = np.asarray(jds.idct2_2d_sharded(coeffs, jax_mesh))
    np.testing.assert_allclose(back, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("geometry", [0, 1])
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_distributed_topk_equals_jax(port, jax_mesh, geometry, ordering):
    k = geometry * len(ORDERINGS) + ORDERINGS.index(ordering)
    coeffs = _plane((32, 64), 2) if geometry == 0 else _plane((34, 66), 3)
    want = _jax_topk(coeffs, N, ordering, jax_mesh) if geometry == 0 else \
        np.asarray(jranking.top_indices(jnp.asarray(coeffs)[None], N,
                                        ordering))[0]
    for rank in port:  # replicated: the same indices on every rank
        np.testing.assert_array_equal(rank["topk"][k], want)


def test_distributed_topk_tie_break(port, jax_mesh):
    want = _jax_topk(_tie_plane(), 3, Ordering.ENERGY, jax_mesh)
    np.testing.assert_array_equal(want, [5, 60, 3 * 64 + 10])
    for rank in port:
        np.testing.assert_array_equal(rank["topk"][-1], [5, 60, 3 * 64 + 10])
