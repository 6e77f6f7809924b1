"""The port's sharded pipelines against its own single-device pipeline and
against the JAX package's sharded pipelines.

The port runs in 4 gloo ranks on the CPU, spawned once for the module
(``parallel.launch.run_ranks`` with ``parallel.dryrun.parity_rank``); the
JAX package on 4 of the test process's virtual CPU devices. Same seeded
numpy inputs (1/f textures). Bounds:

- data parallel, mesh (4, 1): bit-equal to the port's ``pipeline.embed``
  and ``extract`` on the whole batch; against JAX's
  ``embed_batch_sharded``, each tier's single-device parity standard
  (tests/test_torch_pipeline*.py): u8 within one step (and 99.9% equal at
  HIGHEST), self-similarities within 0.1 sigma (0.01 at HIGHEST) and above
  6 sigma;
- spatial, meshes (1, 4) and (2, 2), a size the ranks do not divide
  included: within one u8 step of JAX's ``embed_spatial`` with under 2% of
  values differing, the own mark above 6 sigma read by both packages;
- corpus, mesh (2, 2), height 4*16 + 3: within one step of JAX's
  ``embed_corpus`` with under 10% differing, padding rows zero, own marks
  above 6 sigma and others below 4, and over 99% of the extracted values
  within 5e-2 of the port's single-device ``extract``;
- the row placement: every rank holds Hp/s rows of a zero-padded image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_torch.parallel.dryrun import parity_rank
from spread_spectrum_watermarking_torch.parallel.launch import run_ranks
from spread_spectrum_watermarking_tpu import config as jcfg
from spread_spectrum_watermarking_tpu.bench import (_pink_texture,
                                                    natural_corpus_chunk)
from spread_spectrum_watermarking_tpu.parallel import make_mesh
from spread_spectrum_watermarking_tpu.parallel import pipeline_sharded as jps

N = 200
TIERS = ["default", "high", "highest"]
SPATIAL = [((1, 4), (64, 96)), ((1, 4), (66, 98)), ((2, 2), (66, 98))]
CORPUS_H, CORPUS_W = 4 * 16 + 3, 96


def _dp_inputs():
    rng = np.random.default_rng(0)
    rgb = np.stack([_pink_texture(rng, 64, 96) for _ in range(4)])
    return rgb, rng.standard_normal((4, 1, N)).astype(np.float32)


def _spatial_inputs(i):
    rng = np.random.default_rng(10 + i)
    h, w = SPATIAL[i][1]
    return (_pink_texture(rng, h, w),
            rng.standard_normal((N,)).astype(np.float32))


def _corpus_inputs():
    rng = np.random.default_rng(9)
    imgs = natural_corpus_chunk(4, CORPUS_H, CORPUS_W, rng)
    return imgs, rng.standard_normal((4, N)).astype(np.float32)


@pytest.fixture(scope="module")
def port():
    rgb, marks = _dp_inputs()
    imgs, cmarks = _corpus_inputs()
    cases = {
        "dp": {"shape": (4, 1), "images": rgb, "marks": marks, "n": N,
               "precisions": TIERS},
        "spatial": {"cases": [(SPATIAL[i][0], *_spatial_inputs(i), N)
                              for i in range(len(SPATIAL))]},
        "rows": {"shape": (1, 4), "image": _spatial_inputs(1)[0]},
        "corpus": {"shape": (2, 2), "images": imgs, "marks": cmarks, "n": N},
    }
    res = run_ranks(parity_rank, 4, device="cpu", timeout=240,
                    args=(cases, "cpu"))
    return res


def _jmesh(shape):
    return make_mesh(shape, devices=jax.devices()[:4])


def _own(ext, marks):
    sims = tw.similarity(torch.from_numpy(np.asarray(ext, np.float32)),
                         torch.from_numpy(np.asarray(marks, np.float32)))
    return torch.diagonal(sims).numpy(), sims.numpy()


def _step(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


@pytest.mark.parametrize("tier", TIERS)
def test_dp_is_bit_equal_to_the_single_device_pipeline(port, tier):
    rgb, marks = _dp_inputs()
    p = tw.Precision(tier)
    want = tw.embed(torch.from_numpy(rgb), torch.from_numpy(marks),
                    tw.WriteConfig(precision=p))
    ext = tw.extract(torch.from_numpy(rgb), want, N,
                     tw.ReadConfig(precision=p))
    for rank in port:
        np.testing.assert_array_equal(rank["dp"][tier]["marked"],
                                      want.numpy())
        np.testing.assert_array_equal(rank["dp"][tier]["ext"], ext.numpy())


@pytest.mark.parametrize("tier", TIERS)
def test_dp_matches_jax_at_the_tier_standard(port, tier):
    rgb, marks = _dp_inputs()
    mesh = _jmesh((4, 1))
    jw = jcfg.WriteConfig(precision=jcfg.Precision(tier))
    jr = jcfg.ReadConfig(precision=jcfg.Precision(tier))
    jm = np.asarray(jps.embed_batch_sharded(jnp.asarray(rgb),
                                            jnp.asarray(marks), mesh, jw))
    je = jps.extract_batch_sharded(jnp.asarray(rgb), jnp.asarray(jm), N,
                                   mesh, jr)
    got = port[0]["dp"][tier]
    step = _step(jm, got["marked"])
    assert step.max() <= 1
    if tier == "highest":
        assert (step == 0).mean() >= 0.999
    j_own, _ = _own(je, marks[:, 0])
    t_own, _ = _own(got["ext"], marks[:, 0])
    assert np.all(np.abs(j_own - t_own) <= (0.01 if tier == "highest"
                                            else 0.1))
    assert np.all(t_own > 6.0)


@pytest.mark.parametrize("i", range(len(SPATIAL)))
def test_spatial_embed_matches_jax(port, i):
    shape, (h, w) = SPATIAL[i]
    img, mark = _spatial_inputs(i)
    mesh = _jmesh(shape)
    want = np.asarray(jps.embed_spatial(jnp.asarray(img), jnp.asarray(mark),
                                        mesh))
    got = port[0]["spatial"][i]["marked"]
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    step = _step(want, got)
    assert step.max() <= 1
    assert (step > 0).mean() < 0.02, (step > 0).mean()
    for rank in port:  # every rank gathers the same image
        np.testing.assert_array_equal(rank["spatial"][i]["marked"], got)


@pytest.mark.parametrize("i", range(len(SPATIAL)))
def test_spatial_marks_are_read_by_both_packages(port, i):
    img, mark = _spatial_inputs(i)
    got = port[0]["spatial"][i]
    own, _ = _own(got["ext"][None], mark[None])
    assert own[0] > 6.0
    jext = jps.extract_spatial(jnp.asarray(img), jnp.asarray(got["marked"]),
                               N, _jmesh(SPATIAL[i][0]))
    jown, _ = _own(np.asarray(jext)[None], mark[None])
    assert jown[0] > 6.0
    assert abs(jown[0] - own[0]) <= 0.1


def test_place_row_sharded_never_replicates(port):
    img = _spatial_inputs(1)[0]  # 66 rows over 4 ranks: 17 each, 2 padding
    rows = port[0]["rows"]
    assert list(rows["rows"]) == [17] * 4
    placed = rows["placed"]
    assert placed.shape == (68,) + img.shape[1:]
    np.testing.assert_array_equal(placed[:66], img)
    assert not placed[66:].any()


def _jax_corpus():
    imgs, cmarks = _corpus_inputs()
    mesh = _jmesh((2, 2))
    marked = jps.embed_corpus(jnp.asarray(imgs), jnp.asarray(cmarks), mesh)
    return np.asarray(marked)


def test_corpus_embed_matches_jax(port):
    got = port[0]["corpus"]["marked"]
    want = _jax_corpus()
    assert got.shape == want.shape == (4, 68, CORPUS_W, 3)
    step = _step(want, got)
    assert step.max() <= 1
    assert (step > 0).mean() < 0.10


def test_corpus_keeps_padding_rows_zero(port):
    got = port[0]["corpus"]["marked"]
    assert not got[:, CORPUS_H:].any()
    imgs, _ = _corpus_inputs()
    assert np.any(got[:, :CORPUS_H] != imgs)


def test_corpus_detects_own_marks_only(port):
    _, cmarks = _corpus_inputs()
    own, sims = _own(port[0]["corpus"]["ext"], cmarks)
    assert (own > 6.0).all(), own
    assert (np.abs(sims[~np.eye(4, dtype=bool)]) < 4.0).all(), sims


def test_corpus_extract_agrees_with_the_single_device_extract(port):
    imgs, _ = _corpus_inputs()
    marked = torch.from_numpy(port[0]["corpus"]["marked"][:, :CORPUS_H])
    single = tw.extract(torch.from_numpy(imgs), marked, N).numpy()
    agree = np.abs(port[0]["corpus"]["ext"] - single) < 5e-2
    assert agree.mean() > 0.99, agree.mean()
