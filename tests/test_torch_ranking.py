"""ops/ranking of the port against the JAX package on the same bf16 plane.

JAX selects with ``approx_max_k`` (ties at the boundary unspecified); the
port selects exactly with the tie rule (key desc, index asc). So the two
are held to: equal multisets of selected keys, index recall >= 0.99, equal
values at common indices, and the port's own order and DC rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.config import Ordering as JOrdering
from spread_spectrum_watermarking_tpu.config import Precision as JPrecision
from spread_spectrum_watermarking_tpu.models import pipeline as jp
from spread_spectrum_watermarking_tpu.ops import ranking as jr
from spread_spectrum_watermarking_torch.config import Ordering
from spread_spectrum_watermarking_torch.ops import ranking as tr

N = 200


def _plane(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    rgb = jnp.asarray(np.stack([_pink_texture(rng, h, w) for _ in range(2)]))
    ax = -2 if h <= w else -1
    return jp._second_pass(jp._half_pass(rgb, JPrecision.DEFAULT, ax), ax)


def _keys(plane_f32, idx, ordering):
    """The JAX generation-2 selection key at flat ``idx``, as a signed int."""
    b, h, w = plane_f32.shape
    flat = plane_f32.reshape(b, h * w)
    if ordering != "energy":
        scale = jr._ortho_scale_map(h, w).reshape(-1)
        flat = np.asarray((jnp.asarray(flat, jnp.bfloat16)
                           * jnp.asarray(scale, jnp.bfloat16)).astype(jnp.float32))
    v = np.take_along_axis(flat, idx, axis=-1)
    bits = (np.asarray(jnp.asarray(np.abs(v), jnp.bfloat16)).view(np.uint16)
            .astype(np.int64))
    if ordering == "legacy":
        return np.where(v < 0, -bits, bits)
    return (bits & 0xFFFE) | (v < 0)


def _compare(plane, ordering):
    ji, jv = jr.approx_top_indices(plane, N, JOrdering(ordering))
    pf = np.asarray(plane.astype(jnp.float32))
    ti, tv = tr.approx_top_indices(torch.from_numpy(pf).to(torch.bfloat16), N,
                                   Ordering(ordering))
    return pf, np.asarray(ji), np.asarray(jv), ti.numpy(), tv.numpy()


@pytest.mark.parametrize("h,w", [(64, 96), (96, 64), (37, 59)])
@pytest.mark.parametrize("ordering", ["energy", "energy-orthogonal", "legacy"])
def test_selection_agrees_with_jax(h, w, ordering):
    pf, ji, jv, ti, tv = _compare(_plane(h, w), ordering)
    for b in range(2):
        assert sorted(_keys(pf, ji[None, b], ordering)[0]) == \
            sorted(_keys(pf, ti[None, b], ordering)[0])
        common = np.intersect1d(ji[b], ti[b])
        assert len(common) / N >= 0.99
        jmap = dict(zip(ji[b].tolist(), jv[b].tolist()))
        tmap = dict(zip(ti[b].tolist(), tv[b].tolist()))
        assert all(jmap[i] == tmap[i] for i in common.tolist())


@pytest.mark.parametrize("ordering", ["energy", "legacy"])
def test_port_order_and_dc(ordering):
    pf, _, _, ti, tv = _compare(_plane(37, 59), ordering)
    assert not np.any(ti == 0)
    k = _keys(pf, ti, ordering)
    order_key = k if ordering == "legacy" else k & ~1
    for b in range(2):
        pairs = list(zip((-order_key[b]).tolist(), ti[b].tolist()))
        assert pairs == sorted(pairs)  # (key desc, index asc)


def test_ties_break_toward_lower_index_and_dc_reads_zero():
    plane = torch.ones((1, 8, 8), dtype=torch.bfloat16)
    plane[0, 0, 0] = 100.0  # DC: never ahead of another coefficient
    idx, vals = tr.approx_top_indices(plane, 5, Ordering.ENERGY)
    assert idx.tolist() == [[1, 2, 3, 4, 5]]
    assert vals.tolist() == [[1.0] * 5]
    idx, vals = tr.approx_top_indices(plane, 64, Ordering.ENERGY)
    assert idx[0, -1].item() == 0 and vals[0, -1].item() == 0.0


def test_signs_ride_in_the_key():
    plane = torch.tensor([[[0.0, -3.0], [2.0, -1.0]]], dtype=torch.bfloat16)
    idx, vals = tr.approx_top_indices(plane, 3, Ordering.ENERGY)
    assert idx.tolist() == [[1, 2, 3]]
    assert vals.tolist() == [[-3.0, 2.0, -1.0]]


def test_other_generations_raise():
    # Generation 1 and a custom metric run, as in JAX on the same plane;
    # an unknown generation raises JAX's ValueError.
    plane = _plane(37, 59)
    pf = np.array(plane.astype(jnp.float32))
    tplane = torch.from_numpy(pf).to(torch.bfloat16)
    metric = lambda i, v: v * v  # noqa: E731
    for kw in ({"version": 1}, {"custom_metric": metric}):
        ji, jv = jr.approx_top_indices(plane, N, JOrdering.ENERGY, **kw)
        ti, tv = tr.approx_top_indices(tplane, N, Ordering.ENERGY, **kw)
        for b in range(2):
            common = np.intersect1d(np.asarray(ji[b]), ti[b].numpy())
            assert len(common) / N >= 0.99
            jmap = dict(zip(np.asarray(ji[b]).tolist(),
                            np.asarray(jv[b]).tolist()))
            tmap = dict(zip(ti[b].tolist(), tv[b].tolist()))
            assert all(jmap[i] == tmap[i] for i in common.tolist())
    for version in (0, 3):
        with pytest.raises(ValueError, match="rank_version"):
            tr.approx_top_indices(tplane, 2, Ordering.ENERGY, version=version)
