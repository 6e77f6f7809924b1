#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` (the kernels are built from ``spread_spectrum_watermarking_
torch/csrc`` on first use) and the repository beside it; it imports the
port, torch and numpy, never JAX. Without a card, or without the port, it
exits non-zero and prints no result.

Phases, one line of output each, any failure exits non-zero:

1. device: the card, its power limit, versions, the kernel build;
2. K1 (luma + DCT pass) against its plain version, both modes, three
   geometries and the main path's 1080p batch 48, and both times there;
3. K4 (embed epilogue) against its plain version at 1080p, n = 1000,
   batches 4 and 48, and both times at batch 48;
4. K6a/K6b (the 2-D DCT and its inverse, f32) against their plain versions
   at 444x640, 640x444, 37x59, 48x1080x1920, 1920x1080 and 2x2160x3840,
   and both times at 48x1080x1920;
5. the main path: ``embed_verified`` at 1080p, batch 48, n = 1000, DEFAULT
   on 1/f textures, with the kernels' launch counts from that one call, the
   detection checks, the detect path's bit-equality, agreement with the
   CPU run of the same code on a small input, a stage breakdown,
   images/s on random u8 chained from call to call as ``bench.py`` does,
   and the device's idle share under ``torch.profiler``;
6. the HIGHEST path (every config's default) at the same shape:
   ``embed_verified`` with K6a's launch count from that call, detection,
   ``extract`` bit-equal to its extraction and ``extract_prepared`` within
   0.01 sigma of it, ``embed(sparse_idct=False)`` with K6b's launch count,
   the CPU agreement check, Writer/Reader/Tester on one image, a stage
   breakdown, images/s and the idle share;
7. 4K, batch 8: one ``embed_verified`` on 1/f textures, and images/s.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N = 1000
SIGMA = 6.0
# K1 tolerance against its plain version, per element: one bf16 ulp of the
# larger value, plus twice the worst-case error of summing K f32 terms in
# another order, 2 * K * 2^-24 * sum_k |C y| (Higham's gamma_K bound for
# each of the two sums). It matters only for outputs near zero, where the
# sum cancels; the script prints how much of the bound was used.
F32_U = 2.0 ** -24


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def pink_texture(rng, h: int, w: int) -> np.ndarray:
    """(h, w, 3) u8 with a 1/f amplitude spectrum (the model of natural-image
    statistics that ``spread_spectrum_watermarking_tpu.bench`` uses)."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    out = np.empty((h, w, 3), np.uint8)
    for c in range(3):
        phase = rng.random((h, fx.shape[1])) * 2.0 * np.pi
        spec = (1.0 / f ** 1.2) * np.exp(1j * phase)
        img = np.fft.irfft2(spec, s=(h, w))
        img = (img - img.min()) / (np.ptp(img) + 1e-9)
        out[..., c] = (img * 255.0).astype(np.uint8)
    return out


def textures(seed: int, b: int, h: int, w: int):
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([pink_texture(rng, h, w)
                                      for _ in range(b)])).cuda()


def bf16_ulp(x):
    import torch

    mag = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def abs_term_sum(rgb, base):
    """sum_k |C[., k]| |y[k, .]| for each output of K1: the scale of its
    f32 accumulation error."""
    import torch

    from spread_spectrum_watermarking_torch.ops import colorspace, dct

    if base is None:
        y = colorspace.luma_u8(rgb)
    else:
        y = colorspace.luma_diff(base, rgb)
    y = y.to(torch.bfloat16).float().abs()
    h, w = rgb.shape[1:3]
    c = dct.basis_tensor(min(h, w), rgb.device, torch.bfloat16).float().abs()
    return dct.matmul_f32(c, y) if h <= w else dct.matmul_f32(y, c.t())


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    from spread_spectrum_watermarking_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.library()
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        build_seconds=_build.BUILD_INFO["seconds"],
        build_cached=_build.BUILD_INFO["cached"])


def _compare_k1(rgb, base) -> float:
    """K1 on ``rgb`` (pair mode with ``base``) against its plain version;
    logs the comparison, raises outside the tolerance, returns max |err|."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1

    b, h, w = rgb.shape[:3]
    t = k1.luma_pass(rgb, base).float()
    torch.cuda.synchronize()
    r = k1.luma_pass_reference(rgb, base).float()
    d = (t - r).abs()
    ulp = bf16_ulp(torch.maximum(t.abs(), r.abs()))
    order = F32_U * abs_term_sum(rgb, base)
    used = float(((d - ulp).clamp_min(0) / order).max())
    name = "single" if base is None else "pair"
    log("k1", shape=[b, h, w], mode=name,
        share_differing=float((d > 0).float().mean()),
        share_over_1ulp=float((d > ulp).float().mean()),
        max_abs_err=float(d.max()), max_excess_in_u_sum_abs=used,
        bound_in_u_sum_abs=2 * min(h, w))
    if not used <= 2 * min(h, w):
        raise AssertionError(f"K1 {name} {b}x{h}x{w}: outside tolerance")
    return float(d.max())


def phase_k1() -> dict:
    import torch

    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for b, h, w in [(4, 1080, 1920), (4, 1920, 1080), (2, 444, 640)]:
        rgb = textures(10 + h, b, h, w)
        base = torch.randint(0, 256, rgb.shape, generator=gen, device="cuda",
                             dtype=torch.uint8)
        for mode in (None, base):
            worst = max(worst, _compare_k1(rgb, mode))
    # The main path's shape, on random pixels; then both times.
    rgb = torch.randint(0, 256, (48, 1080, 1920, 3), generator=gen,
                        device="cuda", dtype=torch.uint8)
    base = torch.randint(0, 256, rgb.shape, generator=gen, device="cuda",
                         dtype=torch.uint8)
    times = {}
    for name, mode in (("single", None), ("pair", base)):
        worst = max(worst, _compare_k1(rgb, mode))
        times[name] = (time_ms(lambda: k1.luma_pass(rgb, mode), 5),
                       time_ms(lambda: k1.luma_pass_reference(rgb, mode), 5))
    log("k1_time", shape=[48, 1080, 1920],
        single_ms=times["single"][0], single_plain_ms=times["single"][1],
        pair_ms=times["pair"][0], pair_plain_ms=times["pair"][1])
    return {"max_abs_err": worst, "ms": times["single"][0],
            "plain_ms": times["single"][1]}


def _epilogue_inputs(b: int, h: int, w: int):
    """u8 textures and K4 factors from the real embed path's (delta, idx)."""
    import torch

    from spread_spectrum_watermarking_torch import Method, Ordering, Precision
    from spread_spectrum_watermarking_torch.models import pipeline as tp
    from spread_spectrum_watermarking_torch.ops import modulation

    rgb = textures(20 + b, b, h, w)
    gen = torch.Generator(device="cuda").manual_seed(2)
    marks = torch.randn((b, N), generator=gen, device="cuda")
    idx, vals = tp._rank_and_values_fast(rgb, N, Ordering.ENERGY,
                                         Precision.DEFAULT)
    new = modulation.embed_marks(vals, marks, Method.OPTION2, 0.1)
    a, bf = tp._sparse_idct_factors(new - vals, idx, h, w)
    return rgb, a, bf


def _compare_k4(rgb, a, b) -> int:
    """K4 against its plain version; logs, raises past one u8 step, returns
    the largest step."""
    from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4

    t = k4.embed_epilogue(rgb, a, b).int()
    r = k4.embed_epilogue_reference(rgb, a, b).int()
    d = (t - r).abs()
    log("k4", shape=list(rgb.shape[:3]), n=N,
        share_differing=float((d > 0).float().mean()), max_abs_err=int(d.max()),
        share_changed=float((r != rgb.int()).float().mean()))
    if int(d.max()) > 1:
        raise AssertionError("K4: more than one u8 step from its plain version")
    return int(d.max())


def phase_k4() -> dict:
    from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4

    worst = _compare_k4(*_epilogue_inputs(4, 1080, 1920))
    rgb, a, b = _epilogue_inputs(48, 1080, 1920)  # the main path's shape
    worst = max(worst, _compare_k4(rgb, a, b))
    ms = time_ms(lambda: k4.embed_epilogue(rgb, a, b), 5)
    plain = time_ms(lambda: k4.embed_epilogue_reference(rgb, a, b), 5)
    log("k4_time", shape=[48, 1080, 1920], n=N, ms=ms, plain_ms=plain)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain}


def _compare_k6(x, inverse: bool) -> tuple[float, float]:
    """K6a (or K6b) on ``x`` against its plain version; logs, raises outside
    the gamma bound 2 (H + W) u |L| |X| |R|^T (one more rounding for K6b's
    scale), returns (max |err|, share of the bound used)."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
    from spread_spectrum_watermarking_torch.ops import dct

    b, h, w = x.shape
    kernel = k6.idct2_2d_fused if inverse else k6.dct2_2d_fused
    plain = k6.idct2_2d_fused_reference if inverse else k6.dct2_2d_fused_reference
    t = kernel(x)
    torch.cuda.synchronize()
    d = (t - plain(x)).abs()
    del t
    left = dct.basis_tensor(h, x.device, torch.float32, inverse).abs()
    right = dct.basis_tensor(w, x.device, torch.float32, inverse).abs()
    scale = k6.inverse_scale(h, w) if inverse else 1.0
    units = F32_U * scale * dct.matmul_f32(dct.matmul_f32(left, x.abs()),
                                           right.t())
    bound = 2 * (h + w + int(inverse))
    used = float((d / units).max())
    name = "k6b" if inverse else "k6a"
    log(name, shape=[b, h, w], max_abs_err=float(d.max()),
        share_differing=float((d > 0).float().mean()),
        max_err_in_u_sum_abs=used, bound_in_u_sum_abs=bound,
        share_of_bound_used=used / bound)
    if not used <= bound:
        raise AssertionError(f"{name} {b}x{h}x{w}: outside the gamma bound")
    return float(d.max()), used / bound


def phase_k6() -> tuple[dict, dict]:
    import torch

    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6

    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {False: 0.0, True: 0.0}
    for b, h, w in [(2, 444, 640), (2, 640, 444), (2, 37, 59),
                    (48, 1080, 1920), (1, 1920, 1080), (2, 2160, 3840)]:
        # Luma-like planes in [0, 1]; K6b takes them as coefficients.
        x = torch.rand((b, h, w), generator=gen, device="cuda")
        for inverse in (False, True):
            err, _ = _compare_k6(x, inverse)
            worst[inverse] = max(worst[inverse], err)
        del x
        torch.cuda.empty_cache()
    x = torch.rand((48, 1080, 1920), generator=gen, device="cuda")
    recs = []
    for inverse in (False, True):
        kernel = k6.idct2_2d_fused if inverse else k6.dct2_2d_fused
        plain = (k6.idct2_2d_fused_reference if inverse
                 else k6.dct2_2d_fused_reference)
        recs.append({"max_abs_err": worst[inverse],
                     "ms": time_ms(lambda: kernel(x), 5),
                     "plain_ms": time_ms(lambda: plain(x), 5)})
    log("k6_time", shape=[48, 1080, 1920], k6a_ms=recs[0]["ms"],
        k6a_plain_ms=recs[0]["plain_ms"], k6b_ms=recs[1]["ms"],
        k6b_plain_ms=recs[1]["plain_ms"],
        k6a_tflops=2 * 48 * (1080 * 1080 * 1920 + 1080 * 1920 * 1920)
        / (recs[0]["ms"] * 1e9))
    x4 = torch.rand((2, 2160, 3840), generator=gen, device="cuda")
    log("k6_time", shape=[2, 2160, 3840],
        k6a_ms=time_ms(lambda: k6.dct2_2d_fused(x4), 3),
        k6a_plain_ms=time_ms(lambda: k6.dct2_2d_fused_reference(x4), 3))
    return recs[0], recs[1]


def _check_detection(tag: str, ext, marks, gen) -> dict:
    import torch

    import spread_spectrum_watermarking_torch as wm

    own = torch.diagonal(wm.similarity(ext, marks[:, 0]))
    rand = wm.similarity(ext, torch.randn((4, N), generator=gen,
                                          device="cuda"))
    out = {"min_self_sigma": float(own.min()),
           "max_random_abs_sigma": float(rand.abs().max())}
    if not bool((own > SIGMA).all()):
        raise AssertionError(f"{tag}: a self-similarity is not above {SIGMA}")
    if not out["max_random_abs_sigma"] < SIGMA:
        raise AssertionError(f"{tag}: a random mark reaches {SIGMA} sigma")
    if not bool(ext.isfinite().all()):
        raise AssertionError(f"{tag}: non-finite extraction")
    return out


def _chained_step(x, marks, cfg):
    """One embed_verified call whose output carries a data dependence on its
    extraction, so that chained calls cannot overlap (bench.py)."""
    import torch

    import spread_spectrum_watermarking_torch as wm

    marked, ext = wm.embed_verified(x, marks, cfg)
    flip = (ext[0, 0] * 1e-30).to(torch.uint8)
    marked[0, 0, 0, 0] ^= flip
    return marked


def _images_per_sec(rgb, marks, cfg, runs: int) -> list[float]:
    """One warm-up, then ``runs`` timed calls, each embedding into the last
    call's output."""
    import torch

    imgs = _chained_step(rgb.clone(), marks, cfg)
    torch.cuda.synchronize()
    rates = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        imgs = _chained_step(imgs, marks, cfg)
        end.record()
        torch.cuda.synchronize()
        rates.append(rgb.shape[0] / (start.elapsed_time(end) / 1e3))
    return rates


def _device_profile(rgb, marks, cfg, calls: int = 3) -> dict:
    """torch.profiler over ``calls`` chained calls after a warm-up: the
    window on the host clock, the device's kernel time in it, the idle share
    and the five kernels that take the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    imgs = _chained_step(rgb.clone(), marks, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            imgs = _chained_step(imgs, marks, cfg)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    kernel_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"calls": calls, "window_ms": window_ms, "kernel_ms": kernel_ms,
            "idle_share": (1.0 - kernel_ms / window_ms) if by_name else None,
            "top_kernels_ms": [[name[:60], ms] for name, ms in top]}


def _stage_timer(stages: dict):
    """``run(name, fn)``: calls ``fn``, records its ms in ``stages`` (CUDA
    events around it, then a sync) and returns its result."""
    import torch

    def run(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        stages[name] = start.elapsed_time(end)
        return out
    return run


def _stage_breakdown(rgb, marks, cfg) -> dict:
    """ms per stage of one embed_verified call, CUDA events around each."""
    from spread_spectrum_watermarking_torch.kernels.embed_epilogue import (
        embed_epilogue)
    from spread_spectrum_watermarking_torch.kernels.luma_pass import luma_pass
    from spread_spectrum_watermarking_torch.models import pipeline as tp
    from spread_spectrum_watermarking_torch.ops import dct, modulation, ranking

    h, w = rgb.shape[1:3]
    ax = dct.shorter_axis(h, w)
    stages = {}
    box = {}
    run = _stage_timer(stages)

    for _ in range(2):  # the first round warms up; the second is kept
        box["t"] = run("k1_first_pass", lambda: luma_pass(rgb))
        box["plane"] = run("second_pass", lambda: tp._second_pass(box["t"], ax))
        box["iv"] = run("select", lambda: ranking.approx_top_indices(
            box["plane"], N, cfg.ordering))
        idx, vals = box["iv"]
        box["ab"] = run("modulate_and_factors", lambda: tp._sparse_idct_factors(
            modulation.embed_marks(vals, marks[None].expand(
                rgb.shape[0], *marks.shape), cfg.insertion.method,
                cfg.insertion.alpha) - vals, idx, h, w))
        box["marked"] = run("k4_epilogue",
                            lambda: embed_epilogue(rgb, *box["ab"]))
        box["td"] = run("k1_pair_pass",
                        lambda: luma_pass(box["marked"], rgb))
        run("read_dot_at", lambda: dct.dct2_dot_at(
            box["td"], idx, contracted_axis=ax, precision=cfg.precision))
    return stages


def phase_main_path(k1_rec: dict, k4_rec: dict) -> None:
    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1

    cfg = wm.WriteConfig(precision=wm.Precision.DEFAULT)
    rcfg = wm.ReadConfig(precision=wm.Precision.DEFAULT)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rgb = textures(30, 48, 1080, 1920)
    marks = torch.randn((48, 1, N), generator=gen, device="cuda")
    torch.cuda.synchronize()

    k1.LAUNCHES = 0
    k4.LAUNCHES = 0
    marked, ext = wm.embed_verified(rgb, marks, cfg)
    torch.cuda.synchronize()
    k1_rec["launches"], k4_rec["launches"] = k1.LAUNCHES, k4.LAUNCHES
    if k1.LAUNCHES == 0 or k4.LAUNCHES == 0:
        raise AssertionError(f"main path skipped a kernel: K1 {k1.LAUNCHES}, "
                             f"K4 {k4.LAUNCHES}")

    det = _check_detection("1080p", ext, marks, gen)
    idx, vals = wm.rank_base(rgb, N, rcfg)
    ext2 = wm.extract_ranked(rgb, marked, idx, vals, rcfg)
    if not torch.equal(ext, ext2):
        raise AssertionError("detect path differs from embed_verified")
    if marked.shape != rgb.shape or marked.dtype != torch.uint8:
        raise AssertionError("marked output has the wrong shape or type")
    log("main_path", shape=[48, 1080, 1920], n=N,
        launches_k1=k1_rec["launches"], launches_k4=k4_rec["launches"],
        detect_bit_equal=True,
        share_pixels_changed=float((marked != rgb).float().mean()), **det)

    # The same code on the CPU (plain kernel versions), small input.
    small = textures(40, 2, 96, 128)
    small_marks = torch.randn((2, 1, 200), generator=gen, device="cuda")
    g_marked, g_ext = wm.embed_verified(small, small_marks, cfg)
    c_marked, c_ext = wm.embed_verified(small.cpu(), small_marks.cpu(), cfg)
    g_idx, _ = wm.rank_base(small, 200, rcfg)
    c_idx, _ = wm.rank_base(small.cpu(), 200, rcfg)
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / 200
                      for a, b in zip(g_idx.cpu(), c_idx)])
    step = int((g_marked.cpu().int() - c_marked.int()).abs().max())
    sim_gap = float((torch.diagonal(wm.similarity(g_ext.cpu(), small_marks[:, 0].cpu()))
                     - torch.diagonal(wm.similarity(c_ext, small_marks[:, 0].cpu()))
                     ).abs().max())
    log("cpu_agreement", shape=[2, 96, 128], n=200, idx_recall=recall,
        max_u8_step=step, max_sim_gap_sigma=sim_gap)
    if recall < 0.99 or step > 1 or sim_gap > 0.1:
        raise AssertionError("card and CPU runs of the port disagree")

    log("stages_ms", shape=[48, 1080, 1920], n=N,
        **_stage_breakdown(rgb, marks[0], cfg))

    del marked, ext, ext2, rgb
    rand = torch.randint(0, 256, (48, 1080, 1920, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    rates = _images_per_sec(rand, marks, cfg, runs=5)
    log("main_path_rate", shape=[48, 1080, 1920], n=N,
        images_per_sec_median=statistics.median(rates), runs=rates)
    log("profile", shape=[48, 1080, 1920], n=N,
        **_device_profile(rand, marks, cfg))


def _stage_breakdown_highest(rgb, marks, cfg) -> dict:
    """ms per stage of one HIGHEST embed_verified call (its sparse embed,
    then its read), CUDA events around each."""
    import torch

    from spread_spectrum_watermarking_torch.models import pipeline as tp
    from spread_spectrum_watermarking_torch.ops import (colorspace, dct,
                                                        modulation, ranking)

    b, h, w = rgb.shape[:3]
    stages = {}
    box = {}
    run = _stage_timer(stages)
    ie = cfg.insertion
    for _ in range(2):  # the first round warms up; the second is kept
        rgbf = run("to_f32", lambda: tp._to_f32(rgb))
        y = run("luma", lambda: tp._luma(rgb))
        box["c"] = run("k6a_forward", lambda: dct.dct2_2d(y))
        box["idx"] = run("select", lambda: ranking.top_indices(
            box["c"], N, cfg.ordering))
        idx = box["idx"]
        box["orig"] = run("gather", lambda: torch.gather(
            box["c"].reshape(b, h * w), -1, idx))
        box["new"] = run("modulate", lambda: modulation.embed_marks(
            box["orig"], marks[None].expand(b, *marks.shape), ie.method,
            ie.alpha))
        box["dy"] = run("sparse_delta", lambda: tp._sparse_idct_delta(
            box["new"] - box["orig"], idx, h, w, cfg.precision))
        box["m"] = run("add_and_quantize", lambda: colorspace.f32_to_u8(
            torch.clamp(rgbf + box["dy"][..., None], 0.0, 1.0)))
        yd = run("derived_luma", lambda: tp._luma(box["m"]))
        run("coeffs_at", lambda: dct.dct2_coeffs_at(yd, idx))
    return stages


def phase_highest(k6a_rec: dict, k6b_rec: dict) -> None:
    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
    from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1

    cfg, rcfg = wm.WriteConfig(), wm.ReadConfig()  # HIGHEST, the default
    gen = torch.Generator(device="cuda").manual_seed(6)
    rgb = textures(60, 48, 1080, 1920)
    marks = torch.randn((48, 1, N), generator=gen, device="cuda")
    torch.cuda.synchronize()

    k1.LAUNCHES = k4.LAUNCHES = 0
    k6.FORWARD_LAUNCHES = k6.INVERSE_LAUNCHES = 0
    marked, ext = wm.embed_verified(rgb, marks, cfg)
    torch.cuda.synchronize()
    k6a_rec["launches"] = k6.FORWARD_LAUNCHES
    if k6.FORWARD_LAUNCHES == 0:
        raise AssertionError("the HIGHEST path did not launch K6a")
    det = _check_detection("1080p HIGHEST", ext, marks, gen)
    if marked.shape != rgb.shape or marked.dtype != torch.uint8:
        raise AssertionError("marked output has the wrong shape or type")
    extracted = wm.extract(rgb, marked, N, rcfg)
    if not torch.equal(ext, extracted):
        raise AssertionError("extract differs from embed_verified's read")
    flat, idx = wm.prepare_base(rgb, N, rcfg)
    prepared = wm.extract_prepared(flat, idx, wm.prepare_derived(marked, rcfg),
                                   rcfg)
    del flat
    own = torch.diagonal(wm.similarity(ext, marks[:, 0]))
    gap = float((torch.diagonal(wm.similarity(prepared, marks[:, 0]))
                 - own).abs().max())
    if not gap <= 0.01:
        raise AssertionError(f"extract_prepared is {gap} sigma off")
    log("highest_path", shape=[48, 1080, 1920], n=N,
        launches_k6a=k6a_rec["launches"],
        launches_others=[k1.LAUNCHES, k4.LAUNCHES, k6.INVERSE_LAUNCHES],
        extract_bit_equal=True, prepared_max_gap_sigma=gap,
        share_pixels_changed=float((marked != rgb).float().mean()), **det)

    # The reference's full inverse: K6b.
    k6.FORWARD_LAUNCHES = k6.INVERSE_LAUNCHES = 0
    full = wm.embed(rgb, marks, cfg, sparse_idct=False)
    torch.cuda.synchronize()
    k6b_rec["launches"] = k6.INVERSE_LAUNCHES
    if k6.INVERSE_LAUNCHES == 0:
        raise AssertionError("embed(sparse_idct=False) did not launch K6b")
    step = int((full.int() - marked.int()).abs().max())
    det_full = _check_detection("1080p full inverse",
                                wm.extract(rgb, full, N, rcfg), marks, gen)
    if step > 1:
        raise AssertionError(f"full inverse is {step} steps off the sparse one")
    log("highest_full_inverse", shape=[48, 1080, 1920], n=N,
        launches_k6b=k6b_rec["launches"], max_u8_step_from_sparse=step,
        share_pixels_off_sparse=float((full != marked).float().mean()),
        **det_full)
    del full, extracted, prepared

    # The same code on the CPU (plain kernel versions), small input.
    small = textures(70, 2, 96, 128)
    small_marks = torch.randn((2, 1, 200), generator=gen, device="cuda")
    g_marked, g_ext = wm.embed_verified(small, small_marks, cfg)
    c_marked, c_ext = wm.embed_verified(small.cpu(), small_marks.cpu(), cfg)
    g_idx = wm.prepare_base(small, 200, rcfg)[1].cpu()
    c_idx = wm.prepare_base(small.cpu(), 200, rcfg)[1]
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / 200
                      for a, b in zip(g_idx, c_idx)])
    step = int((g_marked.cpu().int() - c_marked.int()).abs().max())
    sm = small_marks[:, 0].cpu()
    sim_gap = float((torch.diagonal(wm.similarity(g_ext.cpu(), sm))
                     - torch.diagonal(wm.similarity(c_ext, sm))).abs().max())
    log("highest_cpu_agreement", shape=[2, 96, 128], n=200, idx_recall=recall,
        idx_equal=bool(torch.equal(g_idx, c_idx)), max_u8_step=step,
        max_sim_gap_sigma=sim_gap)
    if recall < 0.99 or step > 1 or sim_gap > 0.01:
        raise AssertionError("card and CPU runs of the HIGHEST path disagree")

    # The object API on one image, on the card.
    img = rgb[0].cpu().numpy()
    mark = marks[0, 0].cpu().numpy()
    out = wm.Writer(img, device="cuda").mark(mark)
    got = wm.Reader.base(img, device="cuda").extract(
        wm.Reader.derived(out, device="cuda"), N)
    sim = wm.Tester(got, device="cuda").similarity(mark)
    step = int(np.abs(out.astype(int) - marked[0].cpu().numpy()).max())
    if not (sim.exceeds_sigma(SIGMA) and step <= 1):
        raise AssertionError("Writer/Reader/Tester on the card disagree")
    log("highest_api", shape=list(img.shape), n=N, similarity=sim.similarity,
        max_u8_step_from_batch=step)

    log("highest_stages_ms", shape=[48, 1080, 1920], n=N,
        **_stage_breakdown_highest(rgb, marks[0], cfg))
    del marked, ext, rgb
    torch.cuda.empty_cache()
    rand = torch.randint(0, 256, (48, 1080, 1920, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    rates = _images_per_sec(rand, marks, cfg, runs=3)
    log("highest_rate", shape=[48, 1080, 1920], n=N,
        images_per_sec_median=statistics.median(rates), runs=rates)
    log("highest_profile", shape=[48, 1080, 1920], n=N,
        **_device_profile(rand, marks, cfg))


def phase_4k() -> None:
    import torch

    import spread_spectrum_watermarking_torch as wm

    cfg = wm.WriteConfig(precision=wm.Precision.DEFAULT)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rgb = textures(50, 8, 2160, 3840)
    marks = torch.randn((8, 1, N), generator=gen, device="cuda")
    marked, ext = wm.embed_verified(rgb, marks, cfg)
    det = _check_detection("4K", ext, marks, gen)
    rates = _images_per_sec(rgb, marks, cfg, runs=3)
    log("4k", shape=[8, 2160, 3840], n=N, **det,
        images_per_sec_median=statistics.median(rates), runs=rates)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this check runs only on one",
              file=sys.stderr)
        return 2
    try:
        import spread_spectrum_watermarking_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_device()
    k1_rec = {"name": "luma_pass", "route": "cuda",
              "source": "spread_spectrum_watermarking_torch/csrc/luma_pass.cu",
              "replaces": "spread_spectrum_watermarking_tpu/ops/fused_dct.py:295"
                          " (git b5b6c44^)"}
    k4_rec = {"name": "embed_epilogue", "route": "cuda",
              "source": "spread_spectrum_watermarking_torch/csrc/"
                        "embed_epilogue.cu",
              "replaces": "spread_spectrum_watermarking_tpu/ops/fused_dct.py:446"
                          " (git 6b7c109^)"}
    k1_rec.update(phase_k1())
    torch.cuda.empty_cache()
    k4_rec.update(phase_k4())
    torch.cuda.empty_cache()
    k6_src = "spread_spectrum_watermarking_torch/csrc/dct2d_fused.cu"
    k6_tpu = "spread_spectrum_watermarking_tpu/ops/dct_pallas.py"
    k6a_rec = {"name": "dct2_2d_fused", "route": "cuda", "source": k6_src,
               "replaces": f"{k6_tpu}:58 (git fa94855)"}
    k6b_rec = {"name": "idct2_2d_fused", "route": "cuda", "source": k6_src,
               "replaces": f"{k6_tpu}:97 (git fa94855)"}
    k6a_time, k6b_time = phase_k6()
    k6a_rec.update(k6a_time)
    k6b_rec.update(k6b_time)
    torch.cuda.empty_cache()
    phase_main_path(k1_rec, k4_rec)
    torch.cuda.empty_cache()
    phase_highest(k6a_rec, k6b_rec)
    torch.cuda.empty_cache()
    phase_4k()
    log("done", seconds=time.perf_counter() - t0)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in order} for rec in
                                  (k1_rec, k4_rec, k6a_rec, k6b_rec)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
