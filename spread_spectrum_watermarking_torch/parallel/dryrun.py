"""Drive every parallel mode on ranks spawned on this machine.

:func:`dryrun_multichip` is the counterpart of the root
``__graft_entry__.py``'s ``dryrun_multichip``: data parallel, spatial,
the DP x TP corpus with a height the spatial axis does not divide, and the
staged embed bit-equal to the single-device fast path, each checked on
every rank.

:func:`parity_rank` is the rank target that the tests and
``chip_smoke.py`` spawn (``launch.run_ranks``) to hold each path against a
single-device run: it runs the paths named in its ``cases`` on the given
inputs and returns their global results as numpy arrays, with each path's
kernel launches on the rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..config import Ordering, Precision, ReadConfig, WriteConfig
from ..models import pipeline
from ..ops import modulation
from .dct_sharded import dct2_2d_sharded, idct2_2d_sharded
from .launch import run_ranks
from .mesh import DATA_AXIS, SPATIAL_AXIS, Local, gather, make_mesh, place
from .pipeline_sharded import (_place_row_sharded, embed_batch_sharded,
                               embed_corpus, embed_spatial,
                               extract_batch_sharded, extract_corpus,
                               extract_spatial)
from .pipeline_staged import embed_staged, make_stage_mesh
from .topk_sharded import distributed_top_indices


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _min_own_sigma(ext: torch.Tensor, marks) -> float:
    sims = modulation.similarity(ext, torch.as_tensor(marks).to(ext.device))
    return float(torch.diagonal(sims).min())


def dryrun_rank(device="cuda") -> dict:
    """Every mode once at toy size on this rank's group of ``n`` ranks;
    raises ``AssertionError`` on a failed check, else returns what it
    measured: the smallest own-mark similarity of each mode and whether the
    staged embed was bit-equal (None off the last stage, or with fewer
    than 3 ranks)."""
    n = dist.get_world_size()
    rng = np.random.default_rng(0)
    res: dict = {}

    # DP over all ranks (HIGHEST, the default config: K6a and K7).
    mesh_dp = make_mesh((n, 1), device)
    images = rng.integers(0, 256, (n, 64, 96, 3), dtype=np.uint8)
    marks = rng.standard_normal((n, 1, 100)).astype(np.float32)
    marked = embed_batch_sharded(images, marks, mesh_dp)
    ext = extract_batch_sharded(images, Local(marked), 100, mesh_dp)
    res["dp"] = _min_own_sigma(gather(ext, mesh_dp, {0: DATA_AXIS}),
                               marks[:, 0])
    _check(res["dp"] > 3.0, f"dp: {res['dp']}")

    # TP over all ranks: one image, its rows sharded.
    mesh_tp = make_mesh((1, n), device)
    img = rng.integers(0, 256, (16 * n, 32 * n, 3), dtype=np.uint8)
    mark = rng.standard_normal((100,)).astype(np.float32)
    marked1 = gather(embed_spatial(img, mark, mesh_tp), mesh_tp,
                     {0: SPATIAL_AXIS})
    ext1 = extract_spatial(img, marked1, 100, mesh_tp)
    res["tp"] = _min_own_sigma(ext1[None], mark[None])
    _check(res["tp"] > 3.0, f"tp: {res['tp']}")

    # Joint DP x TP corpus with a height the spatial axis does not divide.
    if n % 2 == 0 and n >= 4:
        nd, ns = 2, n // 2
        mesh = make_mesh((nd, ns), device)
        hc, wc = 16 * ns + 3, 96
        imgs = rng.integers(0, 256, (2 * nd, hc, wc, 3), dtype=np.uint8)
        cmarks = rng.standard_normal((2 * nd, 100)).astype(np.float32)
        marked_pad = embed_corpus(imgs, cmarks, mesh)
        hp = marked_pad.shape[1] * ns
        base_pad = np.pad(imgs, ((0, 0), (0, hp - hc), (0, 0), (0, 0)))
        extc = extract_corpus(base_pad, Local(marked_pad), 100, mesh,
                              height=hc)
        res["corpus"] = _min_own_sigma(gather(extc, mesh, {0: DATA_AXIS}),
                                       cmarks)
        _check(res["corpus"] > 3.0, f"corpus: {res['corpus']}")

    # PP: the staged embed, bit-equal to the fast path per microbatch.
    res["pp_bit_equal"] = None
    if n >= 3:
        cfg = WriteConfig(precision=Precision.DEFAULT)
        mesh_pp = make_stage_mesh(device=device)
        mbs = rng.integers(0, 256, (3, 2, 64, 96, 3), dtype=np.uint8)
        pmark = rng.standard_normal((100,)).astype(np.float32)
        staged = embed_staged(mbs, pmark, mesh_pp, cfg)
        if staged is not None:
            dev = mesh_pp.device
            ref = torch.stack([pipeline.embed(
                torch.from_numpy(mbs[i]).to(dev),
                torch.from_numpy(pmark[None]).to(dev), cfg)
                for i in range(mbs.shape[0])])
            res["pp_bit_equal"] = bool(torch.equal(staged, ref))
            _check(res["pp_bit_equal"], "pp: staged != pipeline.embed")
    return res


def dryrun_multichip(n_ranks: int, device="cuda", backend=None,
                     timeout: float = 600.0) -> list:
    """Run :func:`dryrun_rank` on ``n_ranks`` spawned ranks: NCCL for
    ``"cuda"``, one rank per card, gloo for ``"cpu"`` (``backend="gloo"``
    puts ranks on CUDA devices several to a card). Returns each rank's
    result; raises if any check fails on any rank."""
    return run_ranks(dryrun_rank, n_ranks, backend=backend, device=device,
                     timeout=timeout, args=(device,))


def _cfgs(precision: str):
    p = Precision(precision)
    return WriteConfig(precision=p), ReadConfig(precision=p)


def _dct_case(spec, device):
    mesh = make_mesh(spec["shape"], device)
    out = []
    for y in spec["planes"]:
        coeffs = gather(dct2_2d_sharded(y, mesh), mesh, {-1: SPATIAL_AXIS})
        back = gather(idct2_2d_sharded(coeffs, mesh), mesh,
                      {-2: SPATIAL_AXIS})
        out.append({"coeffs": _np(coeffs), "back": _np(back)})
    return out


def _topk_case(spec, device):
    mesh = make_mesh(spec["shape"], device)
    out = []
    for coeffs, n, ordering in spec["cases"]:
        h, w = coeffs.shape
        blk = place(coeffs, mesh, {-1: SPATIAL_AXIS}, pad=(-1,))
        out.append(_np(distributed_top_indices(blk, n, Ordering(ordering),
                                               h, w, mesh)))
    return out


def _dp_case(spec, device):
    mesh = make_mesh(spec["shape"], device)
    out = {}
    for prec in spec["precisions"]:
        wcfg, rcfg = _cfgs(prec)
        marked = embed_batch_sharded(spec["images"], spec["marks"], mesh,
                                     wcfg)
        ext = extract_batch_sharded(spec["images"], Local(marked),
                                    spec["n"], mesh, rcfg)
        out[prec] = {"marked": _np(gather(marked, mesh, {0: DATA_AXIS})),
                     "ext": _np(gather(ext, mesh, {0: DATA_AXIS}))}
    return out


def _spatial_case(spec, device):
    out = []
    for shape, img, mark, n in spec["cases"]:
        mesh = make_mesh(shape, device)
        wcfg, rcfg = _cfgs(spec.get("precision", "highest"))
        marked = gather(embed_spatial(img, mark, mesh, wcfg), mesh,
                        {0: SPATIAL_AXIS})
        ext = extract_spatial(img, marked, n, mesh, rcfg)
        out.append({"marked": _np(marked), "ext": _np(ext)})
    return out


def _rows_case(spec, device):
    mesh = make_mesh(spec["shape"], device)
    placed = _place_row_sharded(spec["image"], mesh)
    rows = mesh.all_gather(torch.tensor([placed.shape[0]], device=placed.device))
    return {"rows": _np(rows[:, 0]),
            "placed": _np(gather(placed, mesh, {0: SPATIAL_AXIS}))}


def _corpus_case(spec, device):
    mesh = make_mesh(spec["shape"], device)
    wcfg, rcfg = _cfgs(spec.get("precision", "highest"))
    imgs, n = spec["images"], spec["n"]
    h = imgs.shape[1]
    marked_pad = embed_corpus(imgs, spec["marks"], mesh, wcfg)
    hp = marked_pad.shape[1] * mesh.shape[SPATIAL_AXIS]
    base_pad = np.pad(imgs, ((0, 0), (0, hp - h), (0, 0), (0, 0)))
    ext = extract_corpus(base_pad, Local(marked_pad), n, mesh, rcfg,
                         height=h)
    return {"marked": _np(gather(marked_pad, mesh,
                                 {1: SPATIAL_AXIS, 0: DATA_AXIS})),
            "ext": _np(gather(ext, mesh, {0: DATA_AXIS}))}


def _staged_case(spec, device):
    mesh = make_stage_mesh(device=device)
    out = {"runs": [], "run_launches": []}
    for marks, prec in spec["runs"]:
        wcfg, _ = _cfgs(prec)
        kernels.reset_launch_counts()
        res = embed_staged(spec["images"], marks, mesh, wcfg)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        out["runs"].append(None if res is None else _np(res))
        out["run_launches"].append(kernels.launch_counts())
    try:
        embed_staged(spec["images"], spec["runs"][0][0], mesh,
                     WriteConfig(precision=Precision.HIGHEST))
        out["highest_raises"] = False
    except ValueError as e:
        out["highest_raises"] = "fast-tier" in str(e)
    return out


_CASES = {"dct": _dct_case, "topk": _topk_case, "dp": _dp_case,
          "spatial": _spatial_case, "rows": _rows_case,
          "corpus": _corpus_case, "staged": _staged_case,
          "dryrun": lambda spec, device: dryrun_rank(device)}


def parity_rank(cases: dict, device="cuda") -> dict:
    """Run on this rank each path named in ``cases`` (``dct``, ``topk``,
    ``dp``, ``spatial``, ``rows``, ``corpus``, ``staged``, ``dryrun``) on
    the inputs given there; return each path's global results as numpy
    (the staged outputs on the last stage only) and, under ``launches``,
    the kernel launches each path made on this rank (the staged path's
    also per run, under its ``run_launches``)."""
    out: dict = {"launches": {}}
    for name, spec in cases.items():
        kernels.reset_launch_counts()
        out[name] = _CASES[name](spec, device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        out["launches"][name] = kernels.launch_counts()
    return out
