"""The port's staged (pipeline-parallel) embed, its dry run and its
launcher, on gloo ranks on the CPU.

The staged embed runs in 3 ranks spawned once for the module; its output
must be bit-equal to the port's single-device ``pipeline.embed`` per
microbatch at DEFAULT and HIGH, with one mark and with several, as the JAX
package's tests/test_sharded.py holds its own; HIGHEST is refused. It is
also held against the JAX package's ``embed_staged``, run on 3 of the test
process's virtual CPU devices with the same inputs, at each fast tier's
single-device parity standard (tests/test_torch_pipeline*.py): every u8
value within one step, each mark's similarity within 0.1 sigma of JAX's,
and the own mark above 6 sigma.
``dryrun_multichip(4, "cpu")``, the counterpart of the root
``__graft_entry__.py``'s, must pass. A rank's block of a global array is
zero-padded only where asked. The launcher must stop a group that fails,
dies or hangs, within its timeout.
"""

import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_torch import kernels
from spread_spectrum_watermarking_torch.parallel.dryrun import (
    dryrun_multichip,
    parity_rank,
)
from spread_spectrum_watermarking_torch.parallel import mesh as pmesh
from spread_spectrum_watermarking_torch.parallel.launch import run_ranks
from spread_spectrum_watermarking_tpu import config as jcfg
from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.models import pipeline as jp
from spread_spectrum_watermarking_tpu.parallel import pipeline_staged as jps

M, B, H, W, N = 4, 2, 64, 96, 50


def _inputs():
    rng = np.random.default_rng(7)
    imgs = np.stack([np.stack([_pink_texture(rng, H, W) for _ in range(B)])
                     for _ in range(M)])
    return (imgs, rng.standard_normal((N,)).astype(np.float32),
            rng.standard_normal((4, N)).astype(np.float32))


RUNS = [("one", "default"), ("one", "high"), ("four", "default")]


@pytest.fixture(scope="module")
def port():
    imgs, mark, marks4 = _inputs()
    marks = {"one": mark, "four": marks4}
    cases = {"staged": {"images": imgs,
                        "runs": [(marks[m], tier) for m, tier in RUNS]}}
    return run_ranks(parity_rank, 3, device="cpu", timeout=240,
                     args=(cases, "cpu"))


def _reference(imgs, marks, tier):
    cfg = tw.WriteConfig(precision=tw.Precision(tier))
    return np.stack([tw.embed(torch.from_numpy(imgs[i]),
                              torch.from_numpy(marks), cfg).numpy()
                     for i in range(imgs.shape[0])])


@pytest.mark.parametrize("tier", ["default", "high"])
def test_staged_is_bit_equal_to_the_fast_path(port, tier):
    imgs, mark, _ = _inputs()
    got = port[-1]["staged"]["runs"][RUNS.index(("one", tier))]
    assert got.shape == imgs.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _reference(imgs, mark[None], tier))


def test_staged_multimark_is_bit_equal_to_the_fast_path(port):
    imgs, _, marks4 = _inputs()
    np.testing.assert_array_equal(port[-1]["staged"]["runs"][2],
                                  _reference(imgs, marks4, "default"))


@pytest.mark.parametrize("run", range(len(RUNS)))
def test_staged_matches_jax_at_the_tier_standard(port, run):
    # Several marks add up in the image, so each reads at about half the
    # single-mark sigma; the own mark of such an image is their sum.
    imgs, mark, marks4 = _inputs()
    which, tier = RUNS[run]
    marks = {"one": mark[None], "four": marks4}[which]
    mesh = jps.make_stage_mesh(devices=jax.devices()[:3])
    want = np.asarray(jps.embed_staged(
        jnp.asarray(imgs), jnp.asarray(marks), mesh,
        jcfg.WriteConfig(precision=jcfg.Precision(tier))))
    got = port[-1]["staged"]["runs"][run]
    assert got.shape == want.shape == imgs.shape
    step = np.abs(want.astype(int) - got.astype(int))
    assert step.max() <= 1
    refs = torch.from_numpy(np.concatenate([marks, marks.sum(0)[None]]))
    for i in range(M):
        je = jp.extract(jnp.asarray(imgs[i]), jnp.asarray(want[i]), N,
                        jcfg.ReadConfig(precision=jcfg.Precision(tier)))
        te = tw.extract(torch.from_numpy(imgs[i]), torch.from_numpy(got[i]),
                        N, tw.ReadConfig(precision=tw.Precision(tier)))
        j_sims = tw.similarity(torch.from_numpy(np.array(je)), refs).numpy()
        t_sims = tw.similarity(te, refs).numpy()
        assert np.all(np.abs(j_sims - t_sims) <= 0.1)
        assert np.all(t_sims[:, -1] > 6.0)


def test_staged_counts_launches_per_run(port):
    # Every rank returns one launch record per run, each holding every
    # kernel's count from that run alone (all 0 on the CPU, where the
    # plain versions run), so that each run's kernels can be told apart.
    names = set(kernels.launch_counts())
    for rank in port:
        recs = rank["staged"]["run_launches"]
        assert len(recs) == len(RUNS)
        assert all(set(r) == names and not any(r.values()) for r in recs)


def test_staged_returns_on_the_last_stage_only(port):
    for rank in port[:-1]:
        assert rank["staged"]["runs"] == [None] * len(RUNS)


def test_staged_refuses_highest(port):
    assert all(rank["staged"]["highest_raises"] for rank in port)


def test_dryrun_multichip_passes_on_four_cpu_ranks():
    res = dryrun_multichip(4, "cpu", timeout=240)
    assert len(res) == 4
    for rank in res:
        assert min(rank["dp"], rank["tp"], rank["corpus"]) > 3.0
    assert [r["pp_bit_equal"] for r in res] == [None, None, True, None]


def test_blocks_pad_only_where_asked():
    # A rank's block of a global array: zero-extended along a padded dim
    # (only that block is formed), refused where the dim must divide, as a
    # JAX NamedSharding refuses it.
    x = torch.arange(10).reshape(5, 2)
    assert pmesh.padded_size(5, 2) == 6
    np.testing.assert_array_equal(pmesh._block(x, 0, 1, 2, pad=True),
                                  [[6, 7], [8, 9], [0, 0]])
    np.testing.assert_array_equal(pmesh._block(x, 0, 0, 2, pad=True), x[:3])
    np.testing.assert_array_equal(pmesh._block(x, -1, 1, 2, pad=False),
                                  x[:, 1:])
    with pytest.raises(ValueError, match="does not divide"):
        pmesh._block(x, 0, 0, 2, pad=False)


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="math domain error"):
        run_ranks(math.sqrt, 2, device="cpu", timeout=60, args=(-1.0,))


def test_run_ranks_reports_a_rank_that_dies():
    with pytest.raises(RuntimeError, match="exited with code 3"):
        run_ranks(os._exit, 2, device="cpu", timeout=60, args=(3,))


def test_run_ranks_stops_a_hung_group_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(time.sleep, 2, device="cpu", timeout=5, args=(120,))
    assert time.monotonic() - t0 < 60


def test_run_ranks_returns_each_rank_result():
    assert run_ranks(abs, 3, device="cpu", timeout=60, args=(-2,)) == [2] * 3
