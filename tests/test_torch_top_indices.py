"""ops/ranking.top_indices (the HIGHEST selection) against the JAX package:
index for index on the same f32 plane.

JAX selects with one ``lax.top_k`` when the plane is small (size < 4 n 32)
and with its tiled selection otherwise; the two order -0.0 against +0.0
differently, which LEGACY's signed metric reaches. Planes: JAX's own
HIGHEST transform of 1/f textures, and planes with planted ties and
signed zeros, biased so that zeros straddle the selection boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.config import Ordering as JOrdering
from spread_spectrum_watermarking_tpu.models import pipeline as jp
from spread_spectrum_watermarking_tpu.ops import ranking as jr
from spread_spectrum_watermarking_torch.config import Ordering
from spread_spectrum_watermarking_torch.ops import ranking as tr

ORDERINGS = ["energy", "energy-orthogonal", "legacy"]
_jax_top = jax.jit(jr.top_indices, static_argnums=(1, 2, 3, 4))


def _both(plane, n, ordering, exact_only=False):
    j = np.asarray(_jax_top(jnp.asarray(plane), n, JOrdering(ordering),
                            exact_only))
    t = tr.top_indices(torch.from_numpy(plane), n, Ordering(ordering),
                       exact_only)
    return j, t.numpy()


def _planted(seed, h, w, negbias):
    """Quarter-step values (ties), 30% zeros of both signs."""
    rng = np.random.default_rng(seed)
    x = np.round((rng.standard_normal((2, h, w)) - negbias) * 4) / 4
    m = rng.random((2, h, w))
    x[m < 0.15] = 0.0
    x[(m >= 0.15) & (m < 0.3)] = -0.0
    return x.astype(np.float32)


# (h, w, n): the small branch, the tiled one, and the tiled one recursing
# over its tile maxima (tiles >= n * 32).
BRANCHES = [(37, 59, 50), (64, 96, 20), (200, 180, 30)]


@pytest.mark.parametrize("h,w,n", BRANCHES)
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_equal_to_jax_on_its_own_plane(h, w, n, ordering):
    rng = np.random.default_rng(h * w)
    rgb = np.stack([_pink_texture(rng, h, w) for _ in range(2)])
    plane = np.array(jp._forward(jnp.asarray(rgb), jp.Precision.HIGHEST))
    j, t = _both(plane, n, ordering)
    np.testing.assert_array_equal(t, j)
    assert not np.any(t == 0)


@pytest.mark.parametrize("h,w,n", BRANCHES)
@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("negbias", [0.0, 3.0])
def test_equal_to_jax_with_ties_and_signed_zeros(h, w, n, ordering, negbias):
    plane = _planted(h + w + n, h, w, negbias)
    j, t = _both(plane, n, ordering)
    np.testing.assert_array_equal(t, j)


def test_signed_zeros_order_as_in_jax_on_each_branch():
    # LEGACY, mostly negative: the boundary runs through the zeros. The
    # small branch ranks +0.0 ahead of -0.0; the tiled one takes them as
    # equal (index order). Both are JAX's.
    plane = _planted(1, 64, 96, 3.0)
    pos = int((plane > 0).sum())
    flat = plane.reshape(2, -1)
    for exact_only in (True, False):
        j, t = _both(plane, 20, "legacy", exact_only)
        np.testing.assert_array_equal(t, j)
    t_small = _both(plane, 20, "legacy", True)[1]
    t_tiled = _both(plane, 20, "legacy", False)[1]
    zeros_small = np.take_along_axis(flat, t_small, -1) == 0
    assert 0 < pos < 40 and zeros_small.any()
    signs = np.signbit(np.take_along_axis(flat, t_small, -1)[zeros_small])
    assert not signs.all() and not np.array_equal(t_small, t_tiled)


def test_dc_and_custom_metric():
    plane = np.ones((1, 8, 8), np.float32)
    plane[0, 0, 0] = 100.0  # DC: never ahead of another coefficient
    t = tr.top_indices(torch.from_numpy(plane), 64, Ordering.ENERGY)
    assert t[0, -1].item() == 0 and t[0, :5].tolist() == [1, 2, 3, 4, 5]
    j, t = _both(plane, 64, "energy")
    np.testing.assert_array_equal(t, j)
    # A custom metric (signed, position-dependent), index for index with
    # JAX on both of its branches.
    planted = _planted(4, 64, 96, 0.5)
    metric = lambda i, v: v * (1 + i % 3)  # noqa: E731
    for n, exact_only in ((20, False), (20, True), (4, False)):
        j = _jax_top(jnp.asarray(planted), n, JOrdering.ENERGY, exact_only,
                     metric)
        t = tr.top_indices(torch.from_numpy(planted), n, Ordering.ENERGY,
                           exact_only, custom_metric=metric)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert not np.any(t.numpy() == 0)


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_ranking_metric_bit_equal(ordering):
    plane = _planted(2, 37, 59, 0.5) * np.float32(3.7)
    j = np.asarray(jax.jit(jr.ranking_metric, static_argnums=1)(
        jnp.asarray(plane), JOrdering(ordering)))
    t = tr.ranking_metric(torch.from_numpy(plane), Ordering(ordering)).numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
