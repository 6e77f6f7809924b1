"""The ``mark`` driver: a marking job with the CLI's ``-p`` verify.

A closed loop: ``clients`` requests in flight on one stream, each client
issuing its next request when its last one's verdicts are on the host. A
request is ``batch`` distinct images, each with its own N(0, 1) mark,
through ``pipeline.embed_verified``, then ``pipeline.similarity`` of each
image's extraction with its own mark; its verdicts are copied to the host.
Images come from a pool on the device, ``pool_requests`` requests' worth,
cycled; marks from a pool of ``mark_requests`` requests' worth.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import corpus, reference as R
from . import Done, Phases, Spans, host_buffer, sync


class Driver:
    def __init__(self, cell: dict, program, device: torch.device, seed: int):
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.program, self.device, self.seed = program, device, seed
        self.batch = self.traffic["batch"]
        self.clients = self.traffic["clients"]
        self.log = []
        self.spans = Spans()
        self.kept = {}
        self.failed = 0

    # -- set-up ------------------------------------------------------------
    def plan(self, seconds: float) -> None:
        """A closed loop needs no schedule."""

    def setup(self) -> None:
        cfg, t = self.cfg, self.traffic
        self.phases = phases = Phases(self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.pool = corpus.images(gen, t["pool_requests"] * self.batch,
                                  cfg["height"], cfg["width"], self.device,
                                  t["images_per_texture"])
        self.marks = torch.randn(
            (t["mark_requests"], self.batch, 1, cfg["n"]), generator=gen,
            device=self.device)
        phases.done("inputs")
        self.wcfg = self.program.write_config(cfg)
        rng = np.random.default_rng(self.seed)
        self.sample = set(rng.choice(t["sample_from"], t["sample_requests"],
                                     replace=False).tolist())
        self.bufs = [host_buffer((self.batch,), torch.float32, self.device)
                     for _ in range(self.clients)]
        # Every shape the window uses, on every pool slot; the first call
        # loads (and in a new checkout builds) the kernels.
        self._issue(0, keep=False)[1].wait()
        phases.done("first call")
        for k in range(1, t["pool_requests"]):
            self._issue(k, keep=False)[1].wait()
        phases.done("warm-up")

    def _inputs(self, k: int):
        t = self.traffic
        p = k % t["pool_requests"]
        return (self.pool[p * self.batch:(p + 1) * self.batch],
                self.marks[k % t["mark_requests"]])

    def _issue(self, k: int, keep: bool):
        rgb, marks = self._inputs(k)
        pipeline = self.program.pipeline
        marked, ext = pipeline.embed_verified(rgb, marks, self.wcfg)
        verdicts = pipeline.similarity(ext, marks[:, 0, :]).diagonal()
        buf = self.bufs[k % self.clients]
        buf.copy_(verdicts, non_blocking=True)
        done = Done(self.device)
        kept = (marked, ext) if keep else None
        return buf, done, kept

    # -- the window --------------------------------------------------------
    def reset(self) -> None:
        self.log, self.spans, self.kept, self.failed = [], Spans(), {}, 0

    def window(self, seconds: float) -> None:
        inflight = collections.deque()
        k = 0
        t0 = time.perf_counter()
        self.t0, self.t_end = t0, t0 + seconds
        last = None
        while True:
            while len(inflight) < self.clients and \
                    time.perf_counter() < self.t_end:
                s = time.perf_counter()
                buf, done, kept = self._issue(k, keep=True)
                e = time.perf_counter()
                self.spans.add("issue", s, e)
                inflight.append((k, buf, done, kept, s, e))
                k += 1
            if not inflight:
                break
            j, buf, done, kept, s, e = inflight.popleft()
            w = time.perf_counter()
            done.wait()
            t = time.perf_counter()
            self.spans.add("wait for a verdict", w, t)
            verdicts = buf.numpy().copy()
            self.failed += int(not np.isfinite(verdicts).all())
            self.log.append((j, s - t0, e - t0, t - t0))
            if j in self.sample:
                self.kept[j] = (*kept, verdicts)
            last = (j, *kept, verdicts)
        # The last request of the window is always judged.
        if last is not None and last[0] not in self.kept:
            self.kept[last[0]] = last[1:]
        self.issued = k
        sync(self.device)

    def metrics(self, seconds: float) -> dict:
        done_in = sum(1 for _, _, _, t in self.log if t <= seconds)
        return {"mark_images_per_s": done_in * self.batch / seconds}

    def counts(self) -> dict:
        return {"attempted": self.issued, "failed": self.failed}

    def issue_ms(self) -> list:
        return [(e - s) * 1e3 for _, s, e, _ in self.log]

    def work(self) -> list:
        """The window's requests as ``..roofline`` counts them, with the
        distinct rows of each image's ranked indices from the reference's
        ranking of the pool."""
        cfg, t = self.cfg, self.traffic
        rows = distinct_rows(self.pool, cfg)
        b = self.batch
        return [{"images": b, "rows": rows[(j % t["pool_requests"]) * b:
                                           (j % t["pool_requests"] + 1) * b],
                 "k8_calls": 2, "candidates": b} for j, *_ in self.log]

    def free(self) -> None:
        """Drop the program's state; the kept outputs stay."""
        self.wcfg = None
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness -------------------------------------------------------
    def outputs(self) -> dict:
        """The program's outputs of the judged requests: request -> (marked,
        extraction, verdicts, ranking). The ranking is the program's ranked
        indices of the request's images from the entry that its Reader
        caches (``rank_base``, or ``prepare_base`` at HIGHEST), which
        ranks as ``embed_verified`` does; it is judged by itself."""
        pipeline, n = self.program.pipeline, self.cfg["n"]
        rcfg = self.program.read_config(self.cfg)
        out = {}
        for j, kept in sorted(self.kept.items()):
            rgb, _ = self._inputs(j)
            if self.cfg["precision"] == "highest":
                idx = pipeline.prepare_base(rgb, n, rcfg)[1]
            else:
                idx = pipeline.rank_base(rgb, n, rcfg)[0]
            out[j] = (*kept, idx)
        return out

    def control_outputs(self, bits: int) -> dict:
        """The same requests served by the reference at ``bits``."""
        cfg, out = self.cfg, {}
        for j in sorted(self.kept):
            rgb, marks = self._inputs(j)
            marked, ext, verdicts, ranks = [], [], [], []
            for b in range(0, self.batch, BLOCK):
                x, w = rgb[b:b + BLOCK], marks[b:b + BLOCK, 0]
                m, idx, vals = R.embed(x, w, cfg["precision"], cfg["n"],
                                       cfg["alpha"], bits)
                e = R.read(x, m, idx, vals, cfg["alpha"], cfg["precision"],
                           bits)
                marked.append(m)
                ext.append(e)
                verdicts.append(_own_similarity(e, w).cpu().numpy())
                ranks.append(idx)
            out[j] = (torch.cat(marked), torch.cat(ext),
                      np.concatenate(verdicts), torch.cat(ranks))
        return out

    def check(self, outputs: dict) -> dict:
        """The compared numbers of the judged requests, against the plain
        reference at the tier (float64 sums). The reference ranks each
        image again; then, following the ranking that the outputs give
        (judged by itself), it marks the image and reads the program's
        marked image there, with its own values of the image:

        - ``rank_off``: the share of the program's ranked indices that
          differ from the reference's own, position by position;
        - ``bytes_off``: the share of the marked subpixels that differ from
          the reference's marked image (its modulation, inverse and
          rounding);
        - ``ext_p99`` and ``ext_max``: the 99th percentile and the largest
          |extraction - the reference's read of the program's marked
          image|;
        - ``sim_gap``: the largest gap, in sigma, between a verdict and the
          reference's similarity of its read with the image's mark."""
        cfg = self.cfg
        tier, bits = cfg["precision"], R.TIER_BITS[cfg["precision"]]
        h, w = cfg["height"], cfg["width"]
        off = total = moved = ranked = 0
        errs, gaps = [], []
        for j in sorted(outputs):
            marked, ext, verdicts, ranking = outputs[j]
            rgb, marks = self._inputs(j)
            for b in range(0, self.batch, BLOCK):
                x, m = rgb[b:b + BLOCK], marks[b:b + BLOCK, 0]
                at = ranking[b:b + BLOCK].to(x.device).clamp(0, h * w - 1)
                plane = R.forward(x, tier, bits)
                own, _ = R.rank(plane, tier, cfg["n"])
                moved += int((own != at).sum())
                ranked += at.numel()
                vals = R.values_at(plane, at, tier)
                dy = R.inverse(R.modulate(vals, m, cfg["alpha"]), at, h, w,
                               tier, bits)
                pm = marked[b:b + BLOCK].to(x.device)
                off += int((pm != R.apply(x, dy, tier)).sum())
                total += pm.numel()
                re = R.read(x, pm, at, vals, cfg["alpha"], tier, bits)
                pe = ext[b:b + BLOCK].to(x.device, R.F64)
                errs.append((pe - re).abs().flatten().cpu())
                rs = _own_similarity(re, m).cpu().numpy()
                gaps.append(np.abs(np.asarray(verdicts[b:b + BLOCK],
                                              np.float64) - rs))
        err = torch.cat(errs)
        err = torch.where(torch.isnan(err), torch.inf, err)
        gap = np.concatenate(gaps)
        return {"rank_off": moved / ranked,
                "bytes_off": off / total,
                "ext_p99": float(torch.quantile(err, 0.99)),
                "ext_max": float(err.max()),
                "sim_gap": float(np.nan_to_num(gap, nan=np.inf).max())}


#: Images of the reference at a time, to bound its memory.
BLOCK = 8


def distinct_rows(images: torch.Tensor, cfg: dict) -> list:
    """The number of distinct rows of each image's n ranked indices, by
    the reference's ranking at the tier."""
    tier, out = cfg["precision"], []
    for b in range(0, images.shape[0], BLOCK):
        idx, _ = R.rank(R.forward(images[b:b + BLOCK], tier,
                                  R.TIER_BITS[tier]), tier, cfg["n"])
        out += [len(torch.unique(i // cfg["width"])) for i in idx]
    return out


def _own_similarity(ext: torch.Tensor, marks: torch.Tensor) -> torch.Tensor:
    """Each row's similarity with its own mark."""
    e = ext.to(R.F64)
    return (e * marks.to(R.F64)).sum(-1) / torch.sqrt((e * e).sum(-1))
