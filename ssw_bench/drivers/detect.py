"""The ``detect`` driver: the port's detection service (``cli.detect``,
``api.Reader``).

A registry of ``originals``, each given to ``recipients`` recipients with
distinct N(0, 1) marks. Set-up caches each original's ranking as
``Reader._prepared`` does at HIGHEST (``prepare_base``) and makes ``suspects_per_original`` suspect
copies of each: a ``marked_share`` of them carry one recipient's mark,
embedded at the configuration's tier by the plain reference (so the
program makes none of its own inputs); every copy then gets seeded
uniform noise of +-``noise`` u8 steps.

An open loop: requests arrive at ``rate_per_s`` (``..arrivals``), each
``batch`` suspects of one original, originals in turn. The window drives
what ``Reader._extract_stack`` calls at HIGHEST, without its host copies
(``extract_prepared`` of ``prepare_derived``), then
``pipeline.similarity`` against the original's marks (f32), and copies the
top match and its sigma of each suspect to the host. A request is timed
from when it was due to when its answers are on the host.
"""

from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import torch

from .. import arrivals, corpus, reference as R
from . import Done, Phases, Spans, host_buffer, sync

#: Suspects of the reference at a time, to bound its memory.
BLOCK = 8
#: The interpreter's thread switch interval in the window, in seconds: the
#: thread that waits for answers takes the time as soon as one lands, not
#: when the issuing thread next yields (5 ms by default).
SWITCH_S = 2e-5


class Driver:
    def __init__(self, cell: dict, program, device: torch.device, seed: int):
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        if self.cfg["precision"] != "highest":
            raise ValueError("the detect driver reads at HIGHEST only")
        self.program, self.device, self.seed = program, device, seed
        self.batch = self.traffic["batch"]
        self.spans = Spans()
        self.kept = {}

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        cfg, t = self.cfg, self.traffic
        h, w, n = cfg["height"], cfg["width"], cfg["n"]
        o, s, k = t["originals"], t["suspects_per_original"], t["recipients"]
        dev = self.device
        self.phases = phases = Phases(dev)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.originals = corpus.images(gen, o, h, w, dev, 1)
        self.registry = torch.randn((o, k, n), generator=gen, device=dev)
        phases.done("originals and registry")
        marked = int(round(t["marked_share"] * s))
        self.truth = torch.full((o, s), -1, dtype=torch.int64, device=dev)
        self.suspects = torch.empty((o, s, h, w, 3), dtype=torch.uint8,
                                    device=dev)
        tier, bits = cfg["precision"], R.TIER_BITS[cfg["precision"]]
        for i in range(o):
            slots = torch.randperm(s, generator=gen, device=dev)[:marked]
            who = torch.randperm(k, generator=gen, device=dev)[:marked]
            self.truth[i, slots] = who
            base = self.originals[i:i + 1]
            idx, vals = R.rank(R.forward(base, tier, bits), tier, n)
            self.suspects[i] = base
            for b in range(0, marked, BLOCK):
                sl, wh = slots[b:b + BLOCK], who[b:b + BLOCK]
                m = len(sl)
                dy = R.inverse(R.modulate(vals.expand(m, -1),
                                          self.registry[i, wh],
                                          cfg["alpha"]),
                               idx.expand(m, -1), h, w, tier, bits)
                self.suspects[i, sl] = R.apply(base.expand(m, -1, -1, -1),
                                               dy, tier)
            noise = torch.randint(-t["noise"], t["noise"] + 1,
                                  (s, h, w, 3), generator=gen, device=dev,
                                  dtype=torch.int16)
            self.suspects[i] = (self.suspects[i].to(torch.int16) + noise) \
                .clamp(0, 255).to(torch.uint8)
        del noise
        phases.done("suspects")
        self.rcfg = self.program.read_config(cfg)
        # (flat, idx) of each original, as the Reader caches them.
        self.cache = [self.program.pipeline.prepare_base(
            self.originals[i], n, self.rcfg) for i in range(o)]
        self.program_idx = torch.stack([c[1] for c in self.cache])
        phases.done("cached rankings")
        rng = np.random.default_rng(self.seed)
        self.sample = set(rng.choice(t["sample_from"], t["sample_requests"],
                                     replace=False).tolist())
        self.due = arrivals.schedule(t, self._seconds)
        count = len(self.due)
        self.top_s = host_buffer((count, self.batch), torch.float32, dev)
        self.top_i = host_buffer((count, self.batch), torch.int64, dev)
        warm_s = host_buffer((self.batch,), torch.float32, dev)
        warm_i = host_buffer((self.batch,), torch.int64, dev)
        for i in range(2 * o):
            self._issue(i, warm_s, warm_i)[0].wait()
        phases.done("warm-up")

    def plan(self, seconds: float) -> None:
        """The window's length, which sets the schedule (before set-up)."""
        self._seconds = seconds

    def _request(self, i: int):
        """(original, first suspect) of request ``i``."""
        t = self.traffic
        o = i % t["originals"]
        blocks = t["suspects_per_original"] // self.batch
        return o, ((i // t["originals"]) % blocks) * self.batch

    def _issue(self, i: int, out_s, out_i):
        o, first = self._request(i)
        pipeline, b = self.program.pipeline, self.batch
        suspects = self.suspects[o, first:first + b]
        flat, idx = self.cache[o]
        ext = pipeline.extract_prepared(
            flat.expand(b, -1), idx.expand(b, -1),
            pipeline.prepare_derived(suspects, self.rcfg), self.rcfg)
        sims = pipeline.similarity(ext, self.registry[o])
        top_s, top_i = sims.max(dim=1)
        out_s.copy_(top_s, non_blocking=True)
        out_i.copy_(top_i, non_blocking=True)
        return Done(self.device), ext

    # -- the window --------------------------------------------------------
    def reset(self) -> None:
        """Every request writes its answers again; only the kept outputs
        and the host's spans need clearing."""
        self.spans, self.kept = Spans(), {}

    def window(self, seconds: float) -> None:
        count = len(self.due)
        self.sent = np.zeros(count)
        self.issued_at = np.zeros(count)
        self.done = np.zeros(count)
        pending = queue.Queue()

        def waiter():
            while True:
                item = pending.get()
                if item is None:
                    return
                i, done = item
                w = time.perf_counter()
                done.wait()
                t = time.perf_counter()
                self.spans.add("wait for an answer", w, t)
                self.done[i] = t - self.t0

        thread = threading.Thread(target=waiter, daemon=True)
        switch = sys.getswitchinterval()
        sys.setswitchinterval(SWITCH_S)
        self.t0 = t0 = time.perf_counter()
        self.t_end = t0 + seconds
        thread.start()
        last = count - 1
        keep = self.sample | {last}
        try:
            for i, due in enumerate(self.due):
                now = time.perf_counter() - t0
                if due > now:
                    s = time.perf_counter()
                    time.sleep(due - now)
                    self.spans.add("sleep until the next arrival", s,
                                   time.perf_counter())
                s = time.perf_counter()
                self.sent[i] = s - t0
                done, ext = self._issue(i, self.top_s[i], self.top_i[i])
                e = time.perf_counter()
                self.issued_at[i] = e - t0
                self.spans.add("issue", s, e)
                if i in keep:
                    self.kept[i] = ext
                pending.put((i, done))
        finally:
            pending.put(None)
            thread.join()
            sys.setswitchinterval(switch)
        sync(self.device)

    def metrics(self, seconds: float) -> dict:
        lat = (self.done - self.due) * 1e3
        return {"detect_p50_ms": float(np.percentile(lat, 50)),
                "detect_p95_ms": float(np.percentile(lat, 95))}

    def counts(self) -> dict:
        s = self.top_s.numpy()
        return {"attempted": len(self.due),
                "failed": int((~np.isfinite(s)).any(axis=1).sum())}

    def issue_ms(self) -> list:
        return list((self.issued_at - self.sent) * 1e3)

    def late_ms(self) -> list:
        return list((self.sent - self.due) * 1e3)

    def work(self) -> list:
        """The window's requests as ``..roofline`` counts them."""
        k = self.traffic["recipients"]
        return [{"images": self.batch, "k8_calls": 1, "candidates": k}
                for _ in range(len(self.due))]

    def free(self) -> None:
        """Drop the program's state; its cached ranking's indices and the
        kept outputs stay."""
        self.cache = None
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness -------------------------------------------------------
    def outputs(self) -> dict:
        """The program's outputs: the cached ranking's indices, every
        request's answers, and the extractions of the judged requests."""
        return {"idx": self.program_idx,
                "top_s": torch.as_tensor(self.top_s.numpy()),
                "top_i": torch.as_tensor(self.top_i.numpy()),
                "ext": dict(self.kept)}

    def _reference_reads(self, bits: int, idx=None):
        """Per original: ``(ranking, read)``, the reference's ranking at
        ``bits`` and its read of all the original's suspects, (S, n) — at
        that ranking, or at ``idx[o]`` where given, with the reference's
        own values of the original there."""
        cfg = self.cfg
        tier = cfg["precision"]
        out = []
        s = self.suspects.shape[1]
        for o in range(self.traffic["originals"]):
            base = self.originals[o:o + 1]
            plane = R.forward(base, tier, bits)
            own, _ = R.rank(plane, tier, cfg["n"])
            at = own if idx is None else idx[o:o + 1].to(base.device)
            vals = R.values_at(plane, at, tier)
            ext = []
            for b in range(0, s, BLOCK):
                d = self.suspects[o, b:b + BLOCK]
                m = d.shape[0]
                ext.append(R.read(base.expand(m, -1, -1, -1), d,
                                  at.expand(m, -1), vals.expand(m, -1),
                                  cfg["alpha"], tier, bits))
            out.append((own[0], torch.cat(ext)))
        return out

    def _suspect_ids(self) -> torch.Tensor:
        """(requests, batch): each answer's suspect, ``original * S + j``."""
        per = self.traffic["suspects_per_original"]
        first = [o * per + f for o, f in map(self._request,
                                             range(len(self.due)))]
        return torch.tensor(first)[:, None] + torch.arange(self.batch)

    def control_outputs(self, bits: int) -> dict:
        """Every request answered, and the ranking cached, by the reference
        at ``bits``."""
        reads = self._reference_reads(bits)
        best = [R.similarity(e, self.registry[o]).max(dim=1)
                for o, (_, e) in enumerate(reads)]
        sid = self._suspect_ids()
        ext = {}
        for i in self.kept:
            o, first = self._request(i)
            ext[i] = reads[o][1][first:first + self.batch]
        return {"idx": torch.stack([r[0] for r in reads]),
                "top_s": torch.cat([b.values.cpu() for b in best])[sid],
                "top_i": torch.cat([b.indices.cpu() for b in best])[sid],
                "ext": ext}

    def check(self, outputs: dict) -> dict:
        """The compared numbers, against the plain reference at the tier
        (float64 sums). The reference ranks each original again; then,
        following the ranking that the outputs cached, it reads every
        suspect at those indices itself and sweeps it:

        - ``rank_off``: the share of the cached ranked indices that differ
          from the reference's own, position by position;
        - ``ext_p99``: the 99th percentile of |extraction - the reference's
          read| over the judged requests;
        - ``sigma_gap``: the largest gap, in sigma, between an answer's
          sigma and the reference's similarity of the same suspect with the
          same recipient, over every answer of the window;
        - ``top_regret``: the widest gap, in sigma, by which the recipient
          an answer names lies below the reference's best recipient for
          that suspect, over every answer of the window."""
        bits = R.TIER_BITS[self.cfg["precision"]]
        idx = outputs["idx"]
        reads = self._reference_reads(bits, idx)
        ref_idx = torch.stack([r[0] for r in reads]).cpu()
        rank_off = float((idx.cpu() != ref_idx).double().mean())
        sims = torch.cat([R.similarity(e, self.registry[o]).cpu()
                          for o, (_, e) in enumerate(reads)])
        sid = self._suspect_ids()
        top_i = outputs["top_i"].to(torch.int64).clamp(0, sims.shape[1] - 1)
        got = sims[sid, top_i]
        gap = (outputs["top_s"].to(torch.float64) - got).abs()
        gap = torch.where(torch.isnan(gap), torch.inf, gap)
        regret = sims.max(dim=1).values[sid] - got
        regret = torch.where(torch.isnan(regret), torch.inf, regret)
        errs = []
        for i, e in outputs["ext"].items():
            o, first = self._request(i)
            ref = reads[o][1][first:first + self.batch].cpu()
            errs.append((e.to(R.F64).cpu() - ref).abs().flatten())
        err = torch.cat(errs)
        err = torch.where(torch.isnan(err), torch.inf, err)
        return {"rank_off": rank_off,
                "ext_p99": float(torch.quantile(err, 0.99)),
                "sigma_gap": float(gap.max()),
                "top_regret": float(regret.max())}
