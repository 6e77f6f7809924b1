#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` (the kernels are built from ``spread_spectrum_watermarking_
torch/csrc`` on first use) and the repository beside it; it imports the
port, torch and numpy, never JAX. Without a card, or without the port, it
exits non-zero and prints no result.

Phases, one line of output each, any failure exits non-zero:

1. device: the card, its power limit, versions, the kernel build;
2. K1 (luma + DCT pass) against its plain version: its DEFAULT single and
   pair modes and its HIGH mode (bf16x3), at four geometries and the main
   path's 1080p batch 48, each mode's error (and its plain version's)
   against an f64 product at 4 x 1080p in both orientations, with every
   mode's time and its plain version's;
3. K4 (embed epilogue) against its plain version at 1080p, n = 1000,
   batches 4 and 48, and both times at batch 48;
4. K6a/K6b (the 2-D DCT and its inverse, f32, 3xTF32 on the tensor cores)
   against their plain versions at 444x640, 640x444, 37x59, 48x1080x1920,
   1920x1080 and 2x2160x3840; K6a's top-1000 ranking against the plain
   version's on a 48x1080p 1/f-texture luma batch; both kernels' and the
   plain versions' errors against an f64 product at 48x1080x1920; their
   times beside the plain version's and one einsum's at 48x1080x1920 and
   2x2160x3840;
4b. K1f (the folded DCT pass) against its plain version at 4x1080x1920,
   4x1920x1080, 2x64x128 and 2x2160x3840, at DEFAULT and HIGH, both
   orientations, and both against an f64 product at 4 x 1080p; then at 48x1080x1920 and each tier ``dct2_2d(fold=True)``
   with K1f's launch counts from that one call (two at DEFAULT and HIGH,
   none at HIGHEST), held to ``fold=False`` and its inverse to the dense
   inverse, the round trip, the whole transforms' times folded and dense;
   last, at each fast tier, K1f against its plain version on that path's
   own inputs (the plane for the rows pass, the rows pass's output for the
   cols pass), and its times per orientation beside its plain version, its
   bound and one ``torch.matmul`` of the dense pass;
4c. K7 (add and quantize) bit-equal to its plain version at 48x1080x1920
   in both modes, with its times, its bound and the two-rounding form's;
5. the main path: ``embed_verified`` at 1080p, batch 48, n = 1000, DEFAULT
   on 1/f textures, with the kernels' launch counts from that one call, the
   detection checks, the detect path's bit-equality, agreement with the
   CPU run of the same code on a small input, a stage breakdown,
   images/s on random u8 chained from call to call as ``bench.py`` does,
   and the device's idle share under ``torch.profiler``;
6. the HIGH path, the same at ``Precision.HIGH``: K1's high mode, its pair
   mode and K4 launched in the one call, K6 not;
7. the fast tiers' plain-op branches on 4 x 1080p: the full inverse at
   DEFAULT and HIGH read back by the fast Reader, float input at DEFAULT,
   ``prepare_base`` at HIGH;
8. the HIGHEST path (every config's default) at 1080p batch 48:
   ``embed_verified`` with K6a's and K7's launch counts from that call
   (K7 exactly once), detection,
   ``extract`` bit-equal to its extraction and ``extract_prepared`` within
   0.01 sigma of it, ``embed(sparse_idct=False)`` with K6b's launch count,
   the CPU agreement check, Writer/Reader/Tester on one image, a stage
   breakdown, images/s and the idle share;
9. 4K, batch 8: one ``embed_verified`` on 1/f textures at DEFAULT and one
   at HIGH, and images/s of each.

The line before the last is the kernels' JSON record, each kernel with its
time, its plain version's, its bound (the larger of its operations over the
card's peak for their type and its bytes over the memory rate, from this
run's shapes) and one library call's time where one computes the same
function; the last line is ``{"ok": true, "device": {...}}``.
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
# One H100 SXM (NVIDIA's data sheet, dense): bf16 and TF32 tensor-core and
# f32 (outside the tensor cores) peaks, FLOP/s, and the memory rate, bytes/s.
BF16_PEAK = 989e12
TF32_PEAK = 495e12
F32_PEAK = 67e12
HBM_RATE = 3.35e12


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take for the work: the larger of the
    operations over ``peak`` and the bytes (each input read once, each
    output written once) over the memory rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


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


def abs_term_sum(rgb, base, precision):
    """sum_k |C[., k]| |y[k, .]| for each output of K1: the scale of its
    f32 accumulation error (y the bf16 luma, or at HIGH the f32 luma that
    the kernel splits)."""
    import torch

    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.ops import colorspace, dct

    if base is None:
        y = colorspace.luma_u8(rgb)
    else:
        y = colorspace.luma_diff(base, rgb)
    dtype = torch.float32 if precision is Precision.HIGH else torch.bfloat16
    y = y.to(dtype).float().abs()
    h, w = rgb.shape[1:3]
    c = dct.basis_tensor(min(h, w), rgb.device, dtype).float().abs()
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


def _compare_k1(rgb, base, precision) -> float:
    """K1 on ``rgb`` (pair mode with ``base``; high mode at HIGH) against
    its plain version; logs the comparison, raises outside the tolerance,
    returns max |err|. The bound's sum has K terms, or 3K at HIGH (three
    products per k)."""
    import torch

    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1

    b, h, w = rgb.shape[:3]
    t = k1.luma_pass(rgb, base, precision).float()
    torch.cuda.synchronize()
    r = k1.luma_pass_reference(rgb, base, precision).float()
    d = (t - r).abs()
    ulp = bf16_ulp(torch.maximum(t.abs(), r.abs()))
    order = F32_U * abs_term_sum(rgb, base, precision)
    used = float(((d - ulp).clamp_min(0) / order).max())
    terms = min(h, w) * (3 if precision is Precision.HIGH else 1)
    name = ("high" if precision is Precision.HIGH
            else "single" if base is None else "pair")
    log("k1", shape=[b, h, w], mode=name,
        share_differing=float((d > 0).float().mean()),
        share_over_1ulp=float((d > ulp).float().mean()),
        max_abs_err=float(d.max()), max_excess_in_u_sum_abs=used,
        bound_in_u_sum_abs=2 * terms, share_of_bound_used=used / (2 * terms))
    if not used <= 2 * terms:
        raise AssertionError(f"K1 {name} {b}x{h}x{w}: outside tolerance")
    return float(d.max())


def _k1_f64_errors(rgb, base, precision) -> dict:
    """K1's and its plain version's largest error beyond the one bf16
    rounding, against the f64 product of the operands the pass multiplies,
    in units of 2^-24 sum |C y| (``luma_pass.f64_error``)."""
    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1

    return {name: k1.f64_error(fn(rgb, base, precision), rgb, base, precision)
            for name, fn in (("kernel", k1.luma_pass),
                             ("plain", k1.luma_pass_reference))}


def phase_k1() -> tuple[dict, dict, dict]:
    """K1's DEFAULT modes and its HIGH mode against their plain versions,
    their f64 errors at 4 x 1080p in both orientations, and their times:
    the records of ``luma_pass`` (single mode), ``luma_pass_pair`` and
    ``luma_pass_high``."""
    import torch

    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1

    default, high = Precision.DEFAULT, Precision.HIGH
    modes = (("single", False, default), ("pair", True, default),
             ("high", False, high))
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {name: 0.0 for name, _, _ in modes}
    for b, h, w in [(4, 1080, 1920), (4, 1920, 1080), (2, 444, 640),
                    (2, 37, 59)]:
        rgb = textures(10 + h, b, h, w)
        base = torch.randint(0, 256, rgb.shape, generator=gen, device="cuda",
                             dtype=torch.uint8)
        for name, pair, p in modes:
            mode_base = base if pair else None
            worst[name] = max(worst[name], _compare_k1(rgb, mode_base, p))
            if b == 4:
                log("k1_f64", shape=[b, h, w], mode=name,
                    **{f"{k}_max_err_in_u_sum_abs": v for k, v in
                       _k1_f64_errors(rgb, mode_base, p).items()})
        del rgb, base
        torch.cuda.empty_cache()
    # The main path's shape, on random pixels; then the times.
    rgb = torch.randint(0, 256, (48, 1080, 1920, 3), generator=gen,
                        device="cuda", dtype=torch.uint8)
    base = torch.randint(0, 256, rgb.shape, generator=gen, device="cuda",
                         dtype=torch.uint8)
    times = {}
    for name, pair, p in modes:
        mode_base = base if pair else None
        worst[name] = max(worst[name], _compare_k1(rgb, mode_base, p))
        times[name] = (
            time_ms(lambda: k1.luma_pass(rgb, mode_base, p), 5),
            time_ms(lambda: k1.luma_pass_reference(rgb, mode_base, p), 5))
    b, h, w = rgb.shape[:3]
    px, k = b * h * w, min(h, w)
    # Each output sums K products; u8 in (two images in pair mode), bf16
    # out, the bf16 basis (its hi and lo parts at HIGH).
    bounds = {"single": bound(2 * px * k, 5 * px + 2 * k * k, BF16_PEAK),
              "pair": bound(2 * px * k, 8 * px + 2 * k * k, BF16_PEAK),
              "high": bound(6 * px * k, 5 * px + 4 * k * k, BF16_PEAK)}
    log("k1_time", shape=[48, 1080, 1920],
        **{f"{name}_{kind}": t[i] for name, t in times.items()
           for i, kind in enumerate(("ms", "plain_ms"))},
        **{f"{name}_{key}": v for name, bd in bounds.items()
           for key, v in bd.items()})
    return tuple({"max_abs_err": worst[name], "ms": times[name][0],
                  "plain_ms": times[name][1], "library_ms": None,
                  **bounds[name]} for name, _, _ in modes)


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
    bsz, h, w = rgb.shape[:3]
    # An (H, n) @ (n, W) product per image; u8 in and out, bf16 factors.
    bd = bound(2 * bsz * h * w * N, 6 * bsz * h * w + 2 * bsz * N * (h + w),
               BF16_PEAK)
    log("k4_time", shape=[48, 1080, 1920], n=N, ms=ms, plain_ms=plain, **bd)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "library_ms": None, **bd}


def _compare_k6(x, inverse: bool) -> float:
    """K6a (or K6b) on ``x`` against its plain version; logs, raises outside
    ``k6_bound`` (two f32 sums in another order, the TF32 split, K6b's
    scale), returns max |err|."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6

    b, h, w = x.shape
    kernel = k6.idct2_2d_fused if inverse else k6.dct2_2d_fused
    plain = k6.idct2_2d_fused_reference if inverse else k6.dct2_2d_fused_reference
    t = kernel(x)
    torch.cuda.synchronize()
    d = (t - plain(x)).abs()
    del t
    used = float((d / k6.k6_bound(x, inverse)).max())
    name = "k6b" if inverse else "k6a"
    log(name, shape=[b, h, w], max_abs_err=float(d.max()),
        share_differing=float((d > 0).float().mean()),
        share_of_bound_used=used)
    if not used <= 1.0:
        raise AssertionError(f"{name} {b}x{h}x{w}: outside k6_bound")
    return float(d.max())


def _k6_f64_errors(x, inverse: bool) -> dict:
    """The largest error of K6a (K6b) and of its plain version (f32
    cuBLAS) against the f64 product of the same f32 bases (and f32 scale),
    in units of 2^-24 s |L| |X| |R|^T."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
    from spread_spectrum_watermarking_torch.ops import dct

    h, w = x.shape[-2:]
    left, right = (dct.basis_tensor(n, x.device, torch.float32, inverse).double()
                   for n in (h, w))
    scale = k6.inverse_scale(h, w) if inverse else 1.0
    exact = torch.matmul(torch.matmul(left, x.double()), right.t()) * scale
    unit = F32_U * k6.abs_transform(x, inverse)
    kernel = k6.idct2_2d_fused if inverse else k6.dct2_2d_fused
    plain = k6.idct2_2d_fused_reference if inverse else k6.dct2_2d_fused_reference
    out = {f"{name}_max_err_in_u_sum_abs":
           float(((fn(x).double() - exact).abs() / unit).max())
           for name, fn in (("kernel", kernel), ("plain", plain))}
    del exact, unit
    torch.cuda.empty_cache()
    return out


def _k6_ranking(y) -> dict:
    """top_indices(K6a(y), N) against top_indices(plain(y), N) on a luma
    batch: the share of (image, rank) positions that agree, raising below
    0.99 or where a disagreement is not a near-tie. Sorted lists of two
    planes within d of each other differ by at most d at every rank, so
    the |coefficients| of the plain plane at two disagreeing indices are
    within 2 d, d the image's largest ``k6_bound``."""
    from spread_spectrum_watermarking_torch import Ordering
    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
    from spread_spectrum_watermarking_torch.ops import ranking

    b = y.shape[0]
    ck, cp = k6.dct2_2d_fused(y), k6.dct2_2d_fused_reference(y)
    ik = ranking.top_indices(ck, N, Ordering.ENERGY)
    ip = ranking.top_indices(cp, N, Ordering.ENERGY)
    del ck
    differ = ik != ip
    delta = k6.k6_bound(y).reshape(b, -1).amax(1, keepdim=True)
    mag = cp.reshape(b, -1).abs()
    gap = (mag.gather(1, ik) - mag.gather(1, ip)).abs() / delta
    out = {"share_positions_equal": float((~differ).float().mean()),
           "positions_differing": int(differ.sum()),
           "max_gap_in_bounds": float(gap[differ].max()) if bool(differ.any())
           else 0.0,
           "not_near_ties": int((differ & (gap > 2.0)).sum())}
    log("k6_ranking", shape=list(y.shape), n=N, **out)
    if out["share_positions_equal"] < 0.99 or out["not_near_ties"]:
        raise AssertionError(f"K6a's ranking differs from its plain version's: "
                             f"{out}")
    return out


def phase_k6() -> tuple[dict, dict]:
    """K6a/K6b against their plain versions at six geometries, their f64
    errors and K6a's ranking at 48 x 1080p, their times beside the plain
    version's and one einsum's, at 48 x 1080p and 2 x 4K: the records of
    ``dct2_2d_fused`` and ``idct2_2d_fused``."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
    from spread_spectrum_watermarking_torch.ops import colorspace, dct

    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {False: 0.0, True: 0.0}
    for b, h, w in [(2, 444, 640), (2, 640, 444), (2, 37, 59),
                    (48, 1080, 1920), (1, 1920, 1080), (2, 2160, 3840)]:
        # Luma-like planes in [0, 1]; K6b takes them as coefficients.
        x = torch.rand((b, h, w), generator=gen, device="cuda")
        for inverse in (False, True):
            worst[inverse] = max(worst[inverse], _compare_k6(x, inverse))
        del x
        torch.cuda.empty_cache()
    _k6_ranking(colorspace.luma(textures(15, 48, 1080, 1920)))
    torch.cuda.empty_cache()

    def einsum(x, inverse):
        """One library call computing the same function (K6b's scale folded
        into D_h), f32 with TF32 off."""
        h, w = x.shape[-2:]
        left, right = (dct.basis_tensor(n, x.device, torch.float32, inverse)
                       for n in (h, w))
        if inverse:
            left = left * k6.inverse_scale(h, w)

        def call():
            with dct._f32_sums():
                return torch.einsum("hk,bkw,lw->bhl", left, x, right)
        return call

    recs = []
    for shape, reps in (((48, 1080, 1920), 5), ((2, 2160, 3840), 3)):
        x = torch.rand(shape, generator=gen, device="cuda")
        b, h, w = shape
        macs = b * (h * h * w + h * w * w)
        # Three TF32 products per multiply-add on the tensor cores; f32 in
        # and out, the bases' two parts. Beside it, the f32 SIMT bound of
        # the two-product form (the design before 3xTF32).
        bd = bound(3 * 2 * macs, 8 * b * h * w + 8 * (h * h + w * w), TF32_PEAK)
        simt = bound(2 * macs, 8 * b * h * w + 4 * (h * h + w * w), F32_PEAK)
        fields = {}
        for inverse in (False, True):
            tag = "k6b" if inverse else "k6a"
            kernel = k6.idct2_2d_fused if inverse else k6.dct2_2d_fused
            plain = (k6.idct2_2d_fused_reference if inverse
                     else k6.dct2_2d_fused_reference)
            if b == 48:
                fields.update({f"{tag}_f64_{k}": v for k, v in
                               _k6_f64_errors(x, inverse).items()})
            rec = {"ms": time_ms(lambda: kernel(x), reps),
                   "plain_ms": time_ms(lambda: plain(x), reps),
                   "library_ms": time_ms(einsum(x, inverse), reps), **bd}
            fields.update({f"{tag}_{k}": rec[k]
                           for k in ("ms", "plain_ms", "library_ms")})
            fields[f"{tag}_share_of_tf32_peak"] = bd["bound_ms"] / rec["ms"]
            if b == 48:
                recs.append({"max_abs_err": worst[inverse], **rec})
        log("k6_time", shape=list(shape), **bd,
            f32_simt_bound_ms=simt["bound_ms"],
            library="einsum hk,bkw,lw->bhl, f32, TF32 off", **fields)
        del x
        torch.cuda.empty_cache()
    return recs[0], recs[1]


def _compare_k1f(x, axis: int, precision) -> float:
    """K1f on ``x`` against its plain version; logs, raises outside
    2 K u sum |c| |v| (products of bf16 values are exact, so only the order
    of the f32 sums differs; K = N/2 terms, 3N/2 at HIGH), returns
    max |err|."""
    import torch

    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.kernels import fold_pass as k1f

    t = k1f.fold_pass(x, axis, precision=precision)
    torch.cuda.synchronize()
    d = (t - k1f.fold_pass_reference(x, axis, precision=precision)).abs()
    del t
    terms = x.shape[axis] // 2 * (3 if precision is Precision.HIGH else 1)
    scale = (F32_U * k1f.fold_terms(x, axis, precision)).clamp_min(1e-30)
    used = float((d / scale).max())
    log("k1f", shape=list(x.shape), tier=precision.value, axis=axis,
        max_abs_err=float(d.max()),
        share_differing=float((d > 0).float().mean()),
        max_err_in_u_sum_abs=used, bound_in_u_sum_abs=2 * terms,
        share_of_bound_used=used / (2 * terms))
    if not used <= 2 * terms:
        raise AssertionError(f"K1f {precision.value} axis {axis} "
                             f"{list(x.shape)}: outside tolerance")
    return float(d.max())


def _fold_transform_checks(x, precision) -> dict:
    """One ``dct2_2d(fold=True)`` of ``x`` with K1f's launch counts from
    that call, held to ``fold=False``; the inverse fold held to the dense
    inverse of the same coefficients; the round trip. Each side of a
    comparison is within the tier's bound of the exact transform (f32:
    none but its sums; HIGH 2^-12 + 8 (H + W) u; DEFAULT 2^-5, in units of
    |L| |X| |R|^T), so the two are within twice that plus 2 (H + W + 2) u
    for the f32 sums and the roundings of s and d (H + W + 3 for the
    inverse, with its scale)."""
    import torch

    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
    from spread_spectrum_watermarking_torch.ops import dct

    b, h, w = x.shape
    factor = {Precision.HIGHEST: 0.0,
              Precision.HIGH: 2.0 ** -12 + 8 * (h + w) * F32_U,
              Precision.DEFAULT: 2.0 ** -5}[precision]
    _zero_kernel_counts()
    c = dct.dct2_2d(x, precision=precision, fold=True)
    torch.cuda.synchronize()
    counts = _kernel_counts()
    want = {Precision.DEFAULT: (2, 0), Precision.HIGH: (0, 2),
            Precision.HIGHEST: (0, 0)}[precision]
    got = (counts["k1f"], counts["k1f_high"])
    if got != want or sum(counts.values()) != sum(got):
        raise AssertionError(f"dct2_2d(fold=True) at {precision.value} "
                             f"launched {counts}")
    dense = dct.dct2_2d(x, precision=precision)
    fwd = float(((c - dense).abs() / k6.abs_transform(x)).max())
    fwd_bound = 2 * factor + 2 * (h + w + 2) * F32_U
    inv_fold = dct.idct2_2d(dense, precision=precision, fold=True)
    inv = float(((inv_fold - dct.idct2_2d(dense, precision=precision)).abs()
                 / k6.abs_transform(dense, True)).max())
    inv_bound = 2 * factor + 2 * (h + w + 3) * F32_U
    del inv_fold, dense
    trip = float((dct.idct2_2d(c, precision=precision, fold=True)
                  - x).abs().max())
    trip_tol = 0.1 if precision is Precision.DEFAULT else 1e-3
    del c
    out = {"launches": counts, "forward_share_of_bound": fwd / fwd_bound,
           "inverse_share_of_bound": inv / inv_bound,
           "round_trip_max_abs_err": trip, "round_trip_tol": trip_tol}
    if not (fwd <= fwd_bound and inv <= inv_bound and trip <= trip_tol):
        raise AssertionError(f"the folded transforms at {precision.value}: "
                             f"{out}")
    return out


def phase_fold() -> tuple[dict, dict]:
    """K1f against its plain version (and both against f64 at 4 x 1080p,
    both orientations), then the folded transforms at 48 x 1080p and each
    tier, their times against the dense ones, and K1f's
    times per orientation and tier: the records of ``fold_pass`` and
    ``fold_pass_high``."""
    import torch

    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.kernels import fold_pass as k1f
    from spread_spectrum_watermarking_torch.ops import dct

    fast = (Precision.DEFAULT, Precision.HIGH)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for b, h, w in [(4, 1080, 1920), (4, 1920, 1080), (2, 64, 128),
                    (2, 2160, 3840)]:
        x = torch.rand((b, h, w), generator=gen, device="cuda")
        for p in fast:
            for axis in (-2, -1):
                _compare_k1f(x, axis, p)
                if b == 4:  # against f64 (k1f.f64_error), kernel and plain
                    log("k1f_f64", shape=[b, h, w], tier=p.value, axis=axis,
                        **{f"{name}_max_err_in_u_sum_abs": k1f.f64_error(
                            fn(x, axis, precision=p), x, axis, p)
                           for name, fn in (
                               ("kernel", k1f.fold_pass),
                               ("plain", k1f.fold_pass_reference))})
        del x
        torch.cuda.empty_cache()

    x = torch.rand((48, 1080, 1920), generator=gen, device="cuda")
    b, h, w = x.shape
    launches = {}
    for p in (Precision.DEFAULT, Precision.HIGH, Precision.HIGHEST):
        checks = _fold_transform_checks(x, p)
        launches[p] = sum(checks["launches"].values())
        log("fold_transform", shape=[b, h, w], tier=p.value,
            fold_ms=time_ms(lambda: dct.dct2_2d(x, precision=p, fold=True), 5),
            dense_ms=time_ms(lambda: dct.dct2_2d(x, precision=p), 5),
            inverse_fold_ms=time_ms(
                lambda: dct.idct2_2d(x, precision=p, fold=True), 3),
            inverse_dense_ms=time_ms(lambda: dct.idct2_2d(x, precision=p), 3),
            **checks)
        torch.cuda.empty_cache()

    recs = []
    for p in fast:
        high = p is Precision.HIGH
        t = k1f.fold_pass(x, -2, precision=p)  # the cols pass's input
        # Each pass held to its plain version on the main path's own
        # inputs: the plane, then the rows pass's output.
        rec = {"max_abs_err": max(_compare_k1f(x, -2, p),
                                  _compare_k1f(t, -1, p)),
               "launches": launches[p], "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0}
        flops = nbytes = 0
        for axis, v in ((-2, x), (-1, t)):
            n = v.shape[axis]
            c = dct.basis_tensor(n, x.device, torch.float32)
            # The library's dense pass, one torch.matmul: bf16 operands with
            # f32 sums at DEFAULT, f32 at HIGH.
            if high:
                lib = ((lambda: dct.matmul_f32(c, v)) if axis == -2
                       else (lambda: dct.matmul_f32(v, c.t())))
            else:
                cb, vb = c.to(torch.bfloat16), v.to(torch.bfloat16)
                lib = ((lambda: dct.matmul_bf16(cb, vb)) if axis == -2
                       else (lambda: dct.matmul_bf16(vb, cb.t())))
            # Two products of N/2 terms for each of the plane's outputs
            # (three of each at HIGH); f32 in and out, the bf16 halves.
            pf = 2 * (n // 2) * b * h * w * (3 if high else 1)
            pb = 8 * b * h * w + 2 * (n // 2) ** 2 * 2 * (2 if high else 1)
            times = {"ms": time_ms(lambda: k1f.fold_pass(v, axis, precision=p), 5),
                     "plain_ms": time_ms(lambda: k1f.fold_pass_reference(
                         v, axis, precision=p), 5),
                     "library_ms": time_ms(lib, 5)}
            log("k1f_time", shape=[b, h, w], tier=p.value, axis=axis, **times,
                **bound(pf, pb, BF16_PEAK))
            for key, ms in times.items():
                rec[key] += ms
            flops += pf
            nbytes += pb
        recs.append({**rec, **bound(flops, nbytes, BF16_PEAK)})
        del t
        torch.cuda.empty_cache()
    return recs[0], recs[1]


def phase_k7() -> dict:
    """K7 bit-equal to its plain version at 48 x 1080p in both modes, with
    its times, its bound and the two-rounding form's time: the record of
    ``add_quantize`` (its u8 mode, the one the HIGHEST path runs)."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import add_quantize as k7
    from spread_spectrum_watermarking_torch.ops import colorspace

    gen = torch.Generator(device="cuda").manual_seed(12)
    rgb = torch.randint(0, 256, (48, 1080, 1920, 3), generator=gen,
                        device="cuda", dtype=torch.uint8)
    dy = torch.randn((48, 1080, 1920), generator=gen, device="cuda") * 0.01
    fields = {}
    for quantize, mode in ((True, "u8"), (False, "f32")):
        t = k7.add_quantize(rgb, dy, quantize)
        torch.cuda.synchronize()
        r = k7.add_quantize_reference(rgb, dy, quantize)
        if not torch.equal(t.view(torch.uint8), r.view(torch.uint8)):
            raise AssertionError(f"K7 {mode}: not bit-equal to its plain version")
        del t, r
        torch.cuda.empty_cache()
        # u8 and dY in; u8 (or f32) out.
        out_bytes = rgb.numel() * (1 if quantize else 4)
        bd = bound(0, rgb.numel() + 4 * dy.numel() + out_bytes, F32_PEAK)
        fields.update({
            f"{mode}_ms": time_ms(lambda: k7.add_quantize(rgb, dy, quantize), 5),
            f"{mode}_plain_ms": time_ms(
                lambda: k7.add_quantize_reference(rgb, dy, quantize), 3),
            **{f"{mode}_{key}": v for key, v in bd.items()}})
    # The form the card ran before K7: product and sum rounded apart.
    fields["two_rounding_ms"] = time_ms(lambda: colorspace.f32_to_u8(
        torch.clamp(colorspace.u8_to_f32(rgb) + dy[..., None], 0.0, 1.0)), 3)
    log("k7", shape=[48, 1080, 1920], bit_equal_u8=True, bit_equal_f32=True,
        **fields)
    return {"max_abs_err": 0.0, "ms": fields["u8_ms"],
            "plain_ms": fields["u8_plain_ms"], "library_ms": None,
            "bound_ms": fields["u8_bound_ms"], "bound_by": fields["u8_bound_by"]}


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
    and the five kernels that take the most time, each as [name, ms,
    launches recorded] (a kernel the profiler failed to record shows as a
    launch short of ``calls``)."""
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
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
    kernel_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"calls": calls, "window_ms": window_ms, "kernel_ms": kernel_ms,
            "idle_share": (1.0 - kernel_ms / window_ms) if by_name else None,
            "top_kernels_ms": [[name.replace("(anonymous namespace)::", "")[:72],
                                ms, n] for name, (ms, n) in top]}


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
    """ms per stage of one fast-tier embed_verified call, CUDA events
    around each. The read tail runs at DEFAULT at both fast tiers."""
    from spread_spectrum_watermarking_torch import Precision
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

    first = "k1_high_first_pass" if cfg.precision is Precision.HIGH \
        else "k1_first_pass"
    for _ in range(2):  # the first round warms up; the second is kept
        box["t"] = run(first, lambda: luma_pass(rgb, None, cfg.precision))
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
            box["td"], idx, contracted_axis=ax, precision=Precision.DEFAULT))
    return stages


def _kernel_counts() -> dict:
    from spread_spectrum_watermarking_torch.kernels import add_quantize as k7
    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
    from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
    from spread_spectrum_watermarking_torch.kernels import fold_pass as k1f
    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1

    return {"k1": k1.LAUNCHES, "k1_pair": k1.PAIR_LAUNCHES,
            "k1_high": k1.HIGH_LAUNCHES,
            "k4": k4.LAUNCHES, "k6a": k6.FORWARD_LAUNCHES,
            "k6b": k6.INVERSE_LAUNCHES, "k1f": k1f.LAUNCHES,
            "k1f_high": k1f.HIGH_LAUNCHES, "k7": k7.LAUNCHES}


def _zero_kernel_counts() -> None:
    from spread_spectrum_watermarking_torch.kernels import add_quantize as k7
    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
    from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
    from spread_spectrum_watermarking_torch.kernels import fold_pass as k1f
    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1

    k1.LAUNCHES = k1.PAIR_LAUNCHES = k1.HIGH_LAUNCHES = k4.LAUNCHES = 0
    k6.FORWARD_LAUNCHES = k6.INVERSE_LAUNCHES = 0
    k1f.LAUNCHES = k1f.HIGH_LAUNCHES = k7.LAUNCHES = 0


def phase_fast_path(precision, recs: dict) -> None:
    """One fast tier's path at 1080p batch 48: ``embed_verified`` with the
    launch counts of that one call (DEFAULT: K1 and K4; HIGH: K1's high
    mode, its pair mode and K4; never K6), then the checks, the stages,
    the rate and the profile. ``recs``: the kernel records to fill."""
    import torch

    import spread_spectrum_watermarking_torch as wm

    high = precision is wm.Precision.HIGH
    tag = "high_" if high else ""
    cfg = wm.WriteConfig(precision=precision)
    rcfg = wm.ReadConfig(precision=precision)
    gen = torch.Generator(device="cuda").manual_seed(8 if high else 3)
    rgb = textures(80 if high else 30, 48, 1080, 1920)
    marks = torch.randn((48, 1, N), generator=gen, device="cuda")
    torch.cuda.synchronize()

    _zero_kernel_counts()
    marked, ext = wm.embed_verified(rgb, marks, cfg)
    torch.cuda.synchronize()
    counts = _kernel_counts()
    if high:
        recs["luma_pass_high"]["launches"] = counts["k1_high"]
        ran = counts["k1_high"] > 0 and counts["k1"] > 0 and counts["k4"] > 0
    else:
        recs["luma_pass"]["launches"] = counts["k1"] - counts["k1_pair"]
        recs["luma_pass_pair"]["launches"] = counts["k1_pair"]
        recs["embed_epilogue"]["launches"] = counts["k4"]
        ran = (counts["k1"] > counts["k1_pair"] > 0 and counts["k4"] > 0
               and counts["k1_high"] == 0)
    if not ran or any(counts[k] for k in ("k6a", "k6b", "k1f", "k1f_high",
                                          "k7")):
        raise AssertionError(f"{precision.value} path launched {counts}")

    det = _check_detection(f"1080p {precision.value}", ext, marks, gen)
    idx, vals = wm.rank_base(rgb, N, rcfg)
    ext2 = wm.extract_ranked(rgb, marked, idx, vals, rcfg)
    if not torch.equal(ext, ext2):
        raise AssertionError("detect path differs from embed_verified")
    if marked.shape != rgb.shape or marked.dtype != torch.uint8:
        raise AssertionError("marked output has the wrong shape or type")
    log("high_path" if high else "main_path", shape=[48, 1080, 1920], n=N,
        launches=counts, detect_bit_equal=True,
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
    sm = small_marks[:, 0].cpu()
    sim_gap = float((torch.diagonal(wm.similarity(g_ext.cpu(), sm))
                     - torch.diagonal(wm.similarity(c_ext, sm))).abs().max())
    log(f"{tag}cpu_agreement", shape=[2, 96, 128], n=200, idx_recall=recall,
        max_u8_step=step, max_sim_gap_sigma=sim_gap)
    if recall < 0.99 or step > 1 or sim_gap > 0.1:
        raise AssertionError("card and CPU runs of the port disagree")

    log(f"{tag}stages_ms", shape=[48, 1080, 1920], n=N,
        **_stage_breakdown(rgb, marks[0], cfg))

    del marked, ext, ext2, rgb
    rand = torch.randint(0, 256, (48, 1080, 1920, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    rates = _images_per_sec(rand, marks, cfg, runs=5)
    log("high_rate" if high else "main_path_rate", shape=[48, 1080, 1920],
        n=N, images_per_sec_median=statistics.median(rates), runs=rates)
    log(f"{tag}profile", shape=[48, 1080, 1920], n=N,
        **_device_profile(rand, marks, cfg))


def phase_fast_options() -> None:
    """The fast tiers' other branches on 4 x 1080p, which run as plain ops
    where the TPU kernels took u8 only: ``embed(sparse_idct=False)`` at
    DEFAULT and HIGH read back by the fast Reader, ``embed_verified`` of
    float images at DEFAULT, ``prepare_base`` at HIGH."""
    import torch

    import spread_spectrum_watermarking_torch as wm

    gen = torch.Generator(device="cuda").manual_seed(9)
    rgb = textures(90, 4, 1080, 1920)
    marks = torch.randn((4, 1, N), generator=gen, device="cuda")
    out = {}
    for p in (wm.Precision.DEFAULT, wm.Precision.HIGH):
        rcfg = wm.ReadConfig(precision=p)
        full = wm.embed(rgb, marks, wm.WriteConfig(precision=p),
                        sparse_idct=False)
        idx, vals = wm.rank_base(rgb, N, rcfg)
        ext = wm.extract_ranked(rgb, full, idx, vals, rcfg)
        det = _check_detection(f"full inverse {p.value}", ext, marks, gen)
        out[f"full_inverse_{p.value}_min_self_sigma"] = det["min_self_sigma"]
        del full
    cfg = wm.WriteConfig(precision=wm.Precision.DEFAULT)
    marked, ext = wm.embed_verified(rgb.float() / 255.0, marks, cfg)
    det = _check_detection("float input", ext, marks, gen)
    out["float_input_default_min_self_sigma"] = det["min_self_sigma"]
    flat, idx = wm.prepare_base(rgb, N, wm.ReadConfig(precision=wm.Precision.HIGH))
    if flat.shape != (4, 1080 * 1920) or idx.shape != (4, N):
        raise AssertionError("prepare_base at HIGH: wrong shapes")
    if not (bool(flat.isfinite().all())
            and all(len(set(i.tolist())) == N for i in idx.cpu())):
        raise AssertionError("prepare_base at HIGH: bad coefficients or indices")
    log("fast_options", shape=[4, 1080, 1920], n=N,
        float_input_marked_dtype=str(marked.dtype), **out)


def _stage_breakdown_highest(rgb, marks, cfg) -> dict:
    """ms per stage of one HIGHEST embed_verified call (its sparse embed,
    then its read), CUDA events around each."""
    import torch

    from spread_spectrum_watermarking_torch.kernels.add_quantize import (
        add_quantize)
    from spread_spectrum_watermarking_torch.models import pipeline as tp
    from spread_spectrum_watermarking_torch.ops import (colorspace, dct,
                                                        modulation, ranking)

    b, h, w = rgb.shape[:3]
    stages = {}
    box = {}
    run = _stage_timer(stages)
    ie = cfg.insertion
    for _ in range(2):  # the first round warms up; the second is kept
        y = run("luma", lambda: colorspace.luma(rgb))
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
        box["m"] = run("k7_add_quantize",
                       lambda: add_quantize(rgb, box["dy"], True))
        yd = run("derived_luma", lambda: colorspace.luma(box["m"]))
        run("coeffs_at", lambda: dct.dct2_coeffs_at(yd, idx))
    return stages


def phase_highest(k6a_rec: dict, k6b_rec: dict, k7_rec: dict) -> None:
    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6

    cfg, rcfg = wm.WriteConfig(), wm.ReadConfig()  # HIGHEST, the default
    gen = torch.Generator(device="cuda").manual_seed(6)
    rgb = textures(60, 48, 1080, 1920)
    marks = torch.randn((48, 1, N), generator=gen, device="cuda")
    torch.cuda.synchronize()

    _zero_kernel_counts()
    marked, ext = wm.embed_verified(rgb, marks, cfg)
    torch.cuda.synchronize()
    counts = _kernel_counts()
    k6a_rec["launches"] = counts["k6a"]
    k7_rec["launches"] = counts["k7"]
    if counts["k6a"] == 0 or counts["k7"] != 1:
        raise AssertionError(f"the HIGHEST path launched {counts}")
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
    log("highest_path", shape=[48, 1080, 1920], n=N, launches=counts,
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
    """4K, batch 8: one embed_verified at DEFAULT and one at HIGH (K1's
    contraction is 2160 long), each with its rate."""
    import torch

    import spread_spectrum_watermarking_torch as wm

    gen = torch.Generator(device="cuda").manual_seed(4)
    rgb = textures(50, 8, 2160, 3840)
    marks = torch.randn((8, 1, N), generator=gen, device="cuda")
    for p in (wm.Precision.DEFAULT, wm.Precision.HIGH):
        cfg = wm.WriteConfig(precision=p)
        _zero_kernel_counts()
        marked, ext = wm.embed_verified(rgb, marks, cfg)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        det = _check_detection(f"4K {p.value}", ext, marks, gen)
        rates = _images_per_sec(rgb, marks, cfg, runs=3)
        log("4k" if p is wm.Precision.DEFAULT else "4k_high",
            shape=[8, 2160, 3840], n=N, launches=counts, **det,
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
        import spread_spectrum_watermarking_torch as wm
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
    k1p_rec = dict(k1_rec, name="luma_pass_pair",
                   replaces=k1_rec["replaces"] + ", the read tail's pass")
    k1h_rec = dict(k1_rec, name="luma_pass_high",
                   replaces=k1_rec["replaces"] + ", n_dots=3")
    k1_single, k1_pair, k1_high = phase_k1()
    k1_rec.update(k1_single)
    k1p_rec.update(k1_pair)
    k1h_rec.update(k1_high)
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
    k1f_rec = {"name": "fold_pass", "route": "cuda",
               "source": "spread_spectrum_watermarking_torch/csrc/fold_pass.cu",
               "replaces": "spread_spectrum_watermarking_tpu/ops/fused_dct.py:277"
                           " (git 257c497)"}
    k1fh_rec = dict(k1f_rec, name="fold_pass_high",
                    replaces=k1f_rec["replaces"] + ", n_dots=3")
    k1f_default, k1f_high = phase_fold()
    k1f_rec.update(k1f_default)
    k1fh_rec.update(k1f_high)
    torch.cuda.empty_cache()
    k7_rec = {"name": "add_quantize", "route": "cuda",
              "source": "spread_spectrum_watermarking_torch/csrc/add_quantize.cu",
              "replaces": "spread_spectrum_watermarking_tpu/models/pipeline.py:435"
                          " (an XLA fusion; no pallas_call)"}
    k7_rec.update(phase_k7())
    torch.cuda.empty_cache()
    recs = {r["name"]: r for r in (k1_rec, k1p_rec, k1h_rec, k4_rec)}
    phase_fast_path(wm.Precision.DEFAULT, recs)
    torch.cuda.empty_cache()
    phase_fast_path(wm.Precision.HIGH, recs)
    torch.cuda.empty_cache()
    phase_fast_options()
    torch.cuda.empty_cache()
    phase_highest(k6a_rec, k6b_rec, k7_rec)
    torch.cuda.empty_cache()
    phase_4k()
    log("done", seconds=time.perf_counter() - t0)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in order} for rec in
                                  (k1_rec, k1p_rec, k1h_rec, k4_rec, k6a_rec,
                                   k6b_rec, k1f_rec, k1fh_rec, k7_rec)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
