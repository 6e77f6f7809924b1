"""ops/modulation of the port against the JAX package (rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_tpu.config import Method as JMethod
from spread_spectrum_watermarking_tpu.ops import modulation as jm
from spread_spectrum_watermarking_torch import interop
from spread_spectrum_watermarking_torch.config import Method, Precision
from spread_spectrum_watermarking_torch.ops import modulation as tm

RTOL = 1e-5  # the same f32 equations; exp/log and sums may differ by ulps


def _data(seed, shape=(2, 200)):
    rng = np.random.default_rng(seed)
    orig = (rng.standard_normal(shape) * 50.0).astype(np.float32)
    marks = rng.standard_normal(shape).astype(np.float32)
    return orig, marks


@pytest.mark.parametrize("method", ["option1", "option2", "option3"])
def test_insert_and_extract_match(method):
    orig, marks = _data(0)
    ji = np.asarray(jm.insert_values(JMethod(method), 0.1, jnp.asarray(orig),
                                     jnp.asarray(marks)))
    ti = tm.insert_values(Method(method), 0.1, torch.from_numpy(orig),
                          torch.from_numpy(marks))
    np.testing.assert_allclose(ti.numpy(), ji, rtol=RTOL)
    je = np.asarray(jm.extract_values(JMethod(method), 0.1, jnp.asarray(orig),
                                      jnp.asarray(ji)))
    te = tm.extract_values(Method(method), 0.1, torch.from_numpy(orig),
                           torch.from_numpy(ji))
    np.testing.assert_allclose(te.numpy(), je, rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(te.numpy(), marks, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("m", [2, 3])
def test_multi_mark_embedding_matches(m):
    orig, _ = _data(1)
    marks = np.random.default_rng(m).standard_normal((2, m, 200))
    marks = marks.astype(np.float32)
    j = np.asarray(jm.embed_marks(jnp.asarray(orig), jnp.asarray(marks),
                                  JMethod.OPTION2, 0.1))
    t = tm.embed_marks(torch.from_numpy(orig), torch.from_numpy(marks),
                       Method.OPTION2, 0.1)
    np.testing.assert_allclose(t.numpy(), j, rtol=RTOL)


def test_single_mark_forms_agree():
    orig, marks = _data(3)
    o, m = torch.from_numpy(orig), torch.from_numpy(marks)
    one = tm.embed_marks(o, m, Method.OPTION2, 0.1)
    torch.testing.assert_close(tm.embed_marks(o, m[:, None], Method.OPTION2,
                                              0.1), one, rtol=0, atol=0)


def test_similarity_matches_and_thresholds():
    rng = np.random.default_rng(4)
    ext = rng.standard_normal((3, 200)).astype(np.float32)
    cand = rng.standard_normal((5, 200)).astype(np.float32)
    cand[0] = ext[0]
    j = np.asarray(jm.similarity(jnp.asarray(ext), jnp.asarray(cand)))
    t = tm.similarity(torch.from_numpy(ext), torch.from_numpy(cand))
    np.testing.assert_allclose(t.numpy(), j, rtol=RTOL, atol=1e-5)
    assert t[0, 0] > 6.0
    np.testing.assert_array_equal(tm.exceeds_sigma(t, 6.0).numpy(),
                                  np.asarray(jm.exceeds_sigma(jnp.asarray(j), 6.0)))


@pytest.mark.parametrize("name,bound", [("HIGHEST", 0.0), ("HIGH", 1e-3),
                                        ("DEFAULT", 5e-2)])
def test_similarity_precisions_match_jax_and_preserve_detection(name, bound):
    # JAX's third parameter, in the port: one lax.Precision carried to both
    # (interop). As tests/test_modulation.py pins the JAX tiers: HIGH within
    # 1e-3 sigma and DEFAULT within 5e-2 sigma of HIGHEST; against jitted
    # JAX (f32 at every tier on the CPU) within the same bound plus f32
    # reassociation.
    import jax

    rng = np.random.default_rng(3)
    ext = rng.standard_normal((64, 1000)).astype(np.float32)
    marks = rng.standard_normal((256, 1000)).astype(np.float32)
    lax_p = getattr(jax.lax.Precision, name)
    p = interop.precision_from_reference(lax_p)
    assert p is Precision[name]
    te, tk = torch.from_numpy(ext), torch.from_numpy(marks)
    hi = tm.similarity(te, tk).numpy()
    t = tm.similarity(te, tk, precision=p).numpy()
    positional = tm.similarity(te, tk, p).numpy()
    np.testing.assert_array_equal(t, positional)
    assert np.abs(t - hi).max() <= bound
    j = np.asarray(jax.jit(jm.similarity, static_argnums=2)(
        jnp.asarray(ext), jnp.asarray(marks), lax_p))
    assert np.abs(t - j).max() <= bound + 1e-4
    if name != "HIGHEST":
        assert np.abs(t - hi).max() > 0  # the tier is not the f32 product
