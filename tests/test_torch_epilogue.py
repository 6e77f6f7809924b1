"""K4's two launches on the CPU: the factor tile pass's plain version
against the factors of the sparse inverse (the port's and the JAX
package's), and the wrapper's checks and CPU dispatch. The kernel itself
runs only on a CUDA card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold both launches against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_torch.kernels import _build, _tiles
from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
from spread_spectrum_watermarking_torch.ops import dct
from spread_spectrum_watermarking_tpu.ops import dct as jd

GEOMETRIES = [(64, 96), (96, 64), (37, 59)]


def _updates(h, w, n, seed=0, b=2):
    """(delta, idx) as the embed path makes them: n distinct flat indices
    (the DC at 0 among them where n allows) and updates of either sign."""
    rng = np.random.default_rng(seed + n)
    idx = np.stack([rng.choice(h * w, n, replace=False) for _ in range(b)])
    idx[:, 0] = 0
    delta = (rng.standard_normal((b, n)) * 20.0).astype(np.float32)
    return torch.from_numpy(delta), torch.from_numpy(idx)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_factor_tiles_reference_holds_the_factors(h, w, n):
    # Bit for bit, zeros past H, W and n included; the scratch layout the
    # wrapper allocates is the plain version's.
    delta, idx = _updates(h, w, n)
    ta, tb = k4.factor_tiles_reference(delta, idx, h, w)
    assert (tuple(ta.shape), tuple(tb.shape)) == k4._layout(2, h, w, n)
    a, b = dct.sparse_idct_factors(delta, idx, h, w)
    for t, f, rows in ((ta, a, h), (tb, b, w)):
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        rt, kt = t.shape[1:3]
        full = _tiles.untile_image(t, rt * _tiles.ROWS, kt * _tiles.DEPTH)
        assert torch.equal(full[:, :rows, :n], f.transpose(-1, -2))
        assert not bool(full[:, rows:].any()) and not bool(full[:, :, n:].any())


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_sparse_idct_factors_match_jax(h, w):
    # The JAX DEFAULT branch's factors (models/pipeline.py:63-80), under
    # jit: a = bf16((D_h[:, rows] * delta) * f32(4/(W*H))), b = bf16(D_w[:,
    # cols]). The port forms the same two products, each rounded once.
    delta, idx = _updates(h, w, 200, seed=1)

    @jax.jit
    def factors(d, i):
        dh, dw = jnp.asarray(jd.dct3_basis(h)), jnp.asarray(jd.dct3_basis(w))
        a = jnp.moveaxis(jnp.take(dh, i // w, axis=1), 0, 1) * d[..., None, :]
        b = jnp.moveaxis(jnp.take(dw, i % w, axis=1), 0, 1)
        return ((a * (4.0 / (w * h))).astype(jnp.bfloat16),
                b.astype(jnp.bfloat16))

    ja, jb = factors(jnp.asarray(delta.numpy()),
                     jnp.asarray(idx.numpy(), jnp.int32))
    a, b = dct.sparse_idct_factors(delta, idx, h, w)
    for t, j in ((a, ja), (b, jb)):
        np.testing.assert_array_equal(
            t.transpose(-1, -2).float().numpy(),
            np.asarray(j.astype(jnp.float32)))


def test_no_updates_leave_the_image_as_it_is():
    rgb = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 37, 59, 3), dtype=np.uint8))
    delta = torch.zeros((2, 0))
    idx = torch.zeros((2, 0), dtype=torch.int64)
    assert torch.equal(k4.embed_epilogue(rgb, delta, idx), rgb)
    ta, tb = k4.factor_tiles(delta, idx, 37, 59)
    assert ta.shape == (2, 1, 0, 128, 64) and tb.shape == (2, 1, 0, 128, 64)


def _refusals():
    rgb = torch.zeros((2, 37, 59, 3), dtype=torch.uint8)
    delta, idx = _updates(37, 59, 20)
    return {
        "int32 idx": (rgb, delta, idx.to(torch.int32)),
        "f32 rgb": (rgb.float(), delta, idx),
        "f64 delta": (rgb, delta.double(), idx),
        "idx of another shape": (rgb, delta, idx[:, :10]),
        "another batch": (rgb[:1], delta, idx),
        "one image unbatched": (rgb[0], delta[0], idx[0]),
        "delta on another device": (rgb, delta.to("meta"), idx),
        "idx on another device": (rgb, delta, idx.to("meta")),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_embed_epilogue_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        k4.embed_epilogue(*_refusals()[case])


def test_cpu_dispatch_builds_nothing():
    rgb = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 37, 59, 3), dtype=np.uint8))
    delta, idx = _updates(37, 59, 65)
    before = (k4.LAUNCHES, k4.FACTOR_LAUNCHES)
    assert torch.equal(k4.embed_epilogue(rgb, delta, idx),
                       k4.embed_epilogue_reference(rgb, delta, idx))
    for t, r in zip(k4.factor_tiles(delta, idx, 37, 59),
                    k4.factor_tiles_reference(delta, idx, 37, 59)):
        assert torch.equal(t, r)
    assert (k4.LAUNCHES, k4.FACTOR_LAUNCHES) == before
    assert _build._lib is None  # nothing was built or loaded
