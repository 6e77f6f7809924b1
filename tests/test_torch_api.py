"""The port's Writer/Reader/Tester against the JAX package's, at HIGHEST (the
default configs), HIGH and DEFAULT.

Numpy (and PIL) in, numpy out, as in the JAX package; the device is the
keyword ``device``, the card unless ``"cpu"`` is given, as here. Bounds
are each tier's: u8 within one step, index recall >= 0.99,
self-similarities within 0.01 sigma at HIGHEST (0.1 at the fast tiers,
whose selection near ties is JAX's ``approx_max_k``) and above 6 sigma,
random marks below 4 sigma.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import spread_spectrum_watermarking_torch as tw
import spread_spectrum_watermarking_tpu as jw
from spread_spectrum_watermarking_tpu.bench import _pink_texture

N = 200
SIM_TOL = {"highest": 0.01, "high": 0.1, "default": 0.1}


def _image(seed, h=64, w=96):
    return _pink_texture(np.random.default_rng(seed), h, w)


def _configs(precision):
    return (jw.WriteConfig(precision=jw.Precision(precision)),
            jw.ReadConfig(precision=jw.Precision(precision)),
            tw.WriteConfig(precision=tw.Precision(precision)),
            tw.ReadConfig(precision=tw.Precision(precision)))


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("h,w", [(64, 96), (96, 64)])
def test_writer_reader_tester_match_jax(precision, h, w):
    img = _image(h, h, w)
    mark = np.random.default_rng(1).standard_normal(N).astype(np.float32)
    jwc, jrc, twc, trc = _configs(precision)
    jm = jw.Writer(img, jwc).mark(mark)
    tm = tw.Writer(img, twc, device="cpu").mark(mark)
    assert isinstance(tm, np.ndarray) and tm.dtype == np.uint8
    assert tm.shape == img.shape
    assert np.abs(tm.astype(int) - np.asarray(jm).astype(int)).max() <= 1

    reader = tw.Reader.base(img, trc, device="cpu")
    t_ext = reader.extract(tw.Reader.derived(tm, trc, device="cpu"), N)
    j_ext = jw.Reader.base(img, jrc).extract(jw.Reader.derived(jm, jrc), N)
    assert isinstance(t_ext, np.ndarray) and t_ext.shape == (N,)
    t_sim = tw.Tester(t_ext, device="cpu").similarity(mark)
    j_sim = jw.Tester(j_ext).similarity(mark)
    assert abs(t_sim.similarity - j_sim.similarity) <= SIM_TOL[precision]
    assert t_sim.exceeds_sigma(6.0)
    rand = np.random.default_rng(2).standard_normal((8, N)).astype(np.float32)
    assert np.abs(tw.Tester(t_ext, device="cpu").similarities(rand)).max() < 4.0

    # Writer and Reader rank alike in the port; near JAX's.
    t_idx = tw.Writer(img, twc, device="cpu").indices(N)
    np.testing.assert_array_equal(t_idx, reader.indices(N))
    recall = len(np.intersect1d(t_idx, jw.Writer(img, jwc).indices(N))) / N
    assert recall >= 0.99


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_coefficients_match_jax(precision):
    img = _image(3)
    jwc, jrc, twc, trc = _configs(precision)
    t = tw.Writer(img, twc, device="cpu").coefficients()
    j = np.asarray(jw.Writer(img, jwc).coefficients())
    assert t.shape == img.shape[:2] and t.dtype == np.float32
    # f32 transform: 1e-4 of the largest; bf16 plane: a few bf16 ulps.
    rel = 1e-4 if precision == "highest" else 2 ** -6
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * np.abs(j).max())
    reader = tw.Reader(img, trc, device="cpu")
    np.testing.assert_array_equal(reader.coefficients(), t.reshape(-1))
    derived = tw.ReaderDerived(img, trc, device="cpu").coefficients()
    np.testing.assert_array_equal(derived, t.reshape(-1))
    reader.indices(N)  # fills the cache; HIGHEST reads its plane from it
    np.testing.assert_array_equal(reader.coefficients(), t.reshape(-1))


def test_pil_input_float_output_and_update_indices():
    img = _image(4)
    mark = np.random.default_rng(5).standard_normal((2, N)).astype(np.float32)
    writer = tw.Writer(Image.fromarray(img), device="cpu")
    out = writer.mark(mark, quantize=False)
    j_out = np.asarray(jw.Writer(img).mark(mark, quantize=False))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, j_out, rtol=0, atol=1e-5)
    writer.update_indices(tw.Ordering.LEGACY)
    j_writer = jw.Writer(img)
    j_writer.update_indices(jw.Ordering.LEGACY)
    np.testing.assert_array_equal(writer.indices(N), j_writer.indices(N))


def test_reader_refuses_what_the_reference_panics_on():
    img = _image(6)
    reader = tw.Reader.base(img, device="cpu")
    with pytest.raises(ValueError):
        reader.extract(tw.Reader.derived(img[:-1], device="cpu"), N)
    with pytest.raises(ValueError):
        reader.extract(tw.Reader.derived(img, device="cpu"),
                       img.shape[0] * img.shape[1])
    with pytest.raises(ValueError):
        tw.Writer(img[..., :2], device="cpu")
    with pytest.raises(ValueError):
        tw.Tester(np.zeros(N), device="cpu").similarity(np.zeros(N + 1))
    assert repr(tw.Similarity(1.5)) == repr(jw.Similarity(1.5))


def test_wrappers_run_on_the_named_device_only():
    # The wrappers run on the card unless told device="cpu"; they never
    # probe for one, and without a card the default is torch's error, not
    # a fallback to the CPU.
    img = _image(7)
    mark = np.ones(N, np.float32)
    cuda = torch.device("cuda")
    assert tw.Writer(img)._device == cuda
    assert tw.Reader(img)._device == cuda
    assert tw.Reader.base(img)._device == cuda
    assert tw.Reader.derived(img)._device == cuda
    assert tw.ReaderDerived(img)._device == cuda
    assert tw.Tester(mark)._device == cuda
    assert tw.Writer(img, device="cpu")._device == torch.device("cpu")
    if not torch.cuda.is_available():
        for run in (lambda: tw.Writer(img).mark(mark),
                    lambda: tw.Reader.base(img).indices(N),
                    lambda: tw.Reader.derived(img).coefficients(),
                    lambda: tw.Tester(mark).similarity(mark)):
            with pytest.raises((RuntimeError, AssertionError)):
                run()
