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
3. K4 (embed epilogue) on the real path's ``(rgb, delta, idx)`` at 1080p,
   n = 1000, batches 4 and 48: its factor tile pass bit-equal to its plain
   version, the whole kernel within one u8 step of its plain version; its
   time, its plain version's and, as a yardstick for the product alone,
   one bf16 ``torch.matmul`` of the factors, at batch 48;
3b. K5 (the fast tiers' read tail: the pair luma, the first pass at the
   ranked rows only, the dots at the n indices) against its plain version
   (K1's pair mode, then the gather-dot) within ``k5_bound``: at 48 x
   1080p on the main path's marked pair (DEFAULT, n = 1000 ranked indices)
   and on ±3 noise, a 12.5% resize round-trip, a crop-to-black composite
   and an unrelated random image; at 8 x 4K and 4 x 1920 x 1080 on the
   marked and the unrelated pairs; on the harness's random u8 at 48 x
   1080p and 8 x 4K; at 444 x 640, 640 x 444 and 37 x 59 at n = 1, 1000
   and 20,000; each case within ``k5_bound`` and with an f64 error at most
   twice the plain version's plus one unit (``read_tail.gates``); its time
   at 48 x 1080p and 8 x 4K on the textures and on random u8 beside its
   plain version's (on the textures also the old route's and each of its
   two stages), its device launches per call and each one's device time
   from ``torch.profiler``, the peak memory of a call, and its bound from
   the distinct first-pass rows the run's indices need;
3c. K8 (the u8 luma) bit-equal to its plain version, the table of every
   colour's luma: over one 4096 x 4096 image that holds every colour, at
   48 x 1080p on random u8 and on 1/f textures, in portrait (8 x 1920 x
   1080), on a strided view and on an image one byte into its storage;
   its time on both contents beside the table's, its bound and the peak
   memory of a call beside the table's;
3d. K9 (the HIGHEST read: the compaction, the 3xTF32 first pass at the
   distinct rows of the indices on 64-slot tiles walked persistently, the
   dots) against its plain version
   (``dct.dct2_coeffs_at``) within ``k9_bound``, with an f64 error at most
   the plain version's plus one pass's split term and, at 48 x 1080p and
   8 x 4K in landscape and portrait on 1/f textures and on random u8
   (marked at HIGHEST, read at the base's n = 1000 ranked indices), no
   larger than the plain route's; at 444 x 640, 640 x 444 and 37 x 59 at
   n = 1, 1000 and 20,000; its time at 48 x 1080p and 8 x 4K on both
   contents beside its plain version's and the f32 ``torch.matmul``
   pass's, its device launches (at most 3) and each one's device time,
   its peak memory beside the plain version's (never above it), and its
   bound from the distinct rows of the run's indices and its share of it,
   the first pass's share of its own bound beside it;
3e. K10 (HIGHEST's sparse inverse: the compaction, a stable sort of the
   indices by slot, M over each image's distinct rows, G (the shorter
   side's basis at those rows), the 3xTF32 product with K7's rounding in
   its u8 epilogue) against its plain version (the f32 cuBLAS product,
   then K7's plain rounding) through ``highest_inverse.gates``: dY within
   ``k10_bound``, an f64 error at most the plain version's plus one
   pass's split term and, at 48 x 1080p and 8 x 4K in landscape and
   portrait on 1/f textures and on random u8 (the base's n = 1000 ranked
   indices, the updates of n = 1000 marks), no larger than the plain
   route's; the u8 output K7's rounding of its own dY and within one step
   of the plain u8; both modes bit-identical on a second call; the u8
   mode on a crop inside a border (the word units at the view's strides)
   and on a copy one byte into its storage (the byte path) bit-identical
   to the contiguous image's (TMA boxes at 1920 and 3840 wide, the word
   units at 1080); at 444 x 640, 640 x
   444 and 37 x 59 at n = 1, 1000 and 20,000; its time at 48 x 1080p and
   8 x 4K on both contents in both modes beside its plain version's, the
   old route's (the product, then K7) and the f32 ``torch.matmul``
   product's, its device launches (at most ``K10_DEVICE_LAUNCHES``) and
   each one's device time, its peak memory beside the old route's, and
   its bound from the distinct rows of the run's indices, with its share
   and the pass's share of it;
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
4d. K3 (the exact top-n select) index for index (estimates bit for bit)
   equal to its plain version, each call logged with its device launches
   (two up to n = 4096) and the host's microseconds to issue it: the plane
   mode (generation 2's select, re-sort and estimates in one call) over
   the main path's 48x1080x1920 bf16 plane at each ordering, the f32 mode
   over HIGHEST's f32 coefficients at 48 x 1080p at ENERGY and
   ENERGY_ORTHOGONAL (equal to the key mode and the tiled route too), the
   key mode over HIGHEST's int32 key plane, on generation 1's re-sort
   (48, 1000) with flat indices as positions, on the tiled route's
   (48, 32000) candidates, on rows of equal keys and of int32 extremes,
   every mode at n = 1 and n = L on a 37x59 plane and at n = 20,000 (the
   multi-pass path); ``top_indices`` at HIGHEST ENERGY raising the peak of
   allocated memory by less than one f32 plane; each mode's time beside
   its plain version's, one ``torch.topk`` on prebuilt composites and its
   bound;
5. the main path: ``embed_verified`` at 1080p, batch 48, n = 1000, DEFAULT
   on 1/f textures, with the kernels' launch counts from that one call
   (K1, K4, K5 once and no K1 pair mode, and K3's plane mode, its re-sort
   inside: no key-mode launch), the detection checks, the detect path's
   bit-equality, K1's pair mode on its own path
   (``extract(sparse_derived=False)``: launched once, K5 not, within 0.1
   sigma of K5's read), agreement with the CPU run of the same code on a
   small input, a stage breakdown (K5's read tail, and beside it the old
   route's two stages),
   images/s from the port's bench harness (``bench.run_verified_bench``:
   random u8, each call marking the last call's output, the median of
   three timed chains), and the device's idle share under
   ``torch.profiler``;
6. the HIGH path, the same at ``Precision.HIGH``: K1's high mode, K5 and
   K4 launched in the one call, K1's pair mode and K6 not;
6b. rank generation 1 (``rank_version=1``), the same checks at DEFAULT and
   at HIGH (K1, its high mode at HIGH, K4, and K3's key mode at least
   twice launched, K5 once: its record's launches come from the DEFAULT
   call),
   its rate from the harness's ``_timed_chain``;
6c. the custom callables on 4 x 1080p at each tier, each a reimplementation
   of a built-in held to it: Option2 as ``custom_insert`` bit for bit, its
   inverse as ``custom_extract`` within 1e-3 sigma, the ENERGY metric as
   ``custom_ordering`` (the same indices at HIGHEST, a share of at least
   0.95 in common at the fast tiers), with the tier's kernels and K3
   launched in every call;
7. the fast tiers' plain-op branches on 4 x 1080p: the full inverse at
   DEFAULT and HIGH read back by the fast Reader, float input at DEFAULT,
   ``prepare_base`` at HIGH;
8. the HIGHEST path (every config's default) at 1080p batch 48:
   ``embed_verified`` with K6a's, K10's, K3's f32-mode, K8's and K9's
   launch counts from that call (K8 twice, K6a, K10 and K9 exactly once,
   K7 and K3's key mode never, no call of the plain read
   ``dct2_coeffs_at`` or of the f32 cuBLAS sparse product) and its peak
   memory, ``embed`` alone (K10 once, K7 never, bit-equal), detection,
   the sigmas within 0.01 of the plain route's read (the table's lumas,
   ``dct2_coeffs_at``),
   ``extract`` bit-equal to its extraction and ``extract_prepared`` within
   0.01 sigma of it, ``embed(sparse_idct=False)`` with K6b's launch count,
   the CPU agreement check, Writer/Reader/Tester on one image
   (``Writer.mark``: K10 once, K7 never), a stage
   breakdown, images/s on the textures (chained as the harness chains
   calls) and from the harness (random u8), and the idle share;
9. 4K, batch 8: one ``embed_verified`` on 1/f textures at DEFAULT and one
   at HIGH, and images/s of each from the harness;
10. the bench harness's configs at their JAX defaults on the card: the
   separate-calls throughput (HIGH), the batch-1 latency, the
   reader-cached extraction (DEFAULT), the 1024 x 10 000 similarity sweep
   at each precision and the 1024-image corpus (HIGH, chunk 64; every
   image's own mark its top match, above 6 sigma);
11. the command line (``cli.main``, in this process) at 1080p: ``batch``
   over 48 1/f textures saved as JPEG q 95, at HIGHEST (the CLI's default;
   K6a launched, K10 once for the one shape, K7 never) and at DEFAULT (K1
   and K4), 48 PNG/JSON pairs each; ``test`` on four outputs of each tier
   (its own mark matches, a foreign one does not); ``detect`` at each tier
   on one base and 50 derived paths of its shape (its marked PNG and a JPEG
   q 90 re-encode above 6 sigma, the base itself 0.0, the other 47 outputs
   below 6 sigma), its records equal to a run in chunks of one within 1e-5
   sigma; and one ``python -m spread_spectrum_watermarking_torch.cli
   watermark -p`` subprocess that must exceed 6 sigma. It prints the wall
   images/s of ``batch`` and ``detect`` (decode and encode included:
   recorded, not gated) beside the card's name and power limit, each host
   and device piece of them timed alone (``cli_breakdown``), and a
   ``native`` line: the native RNG's build, bit-equal to its pure-Python
   version at seed 1, length 1000, and the codec's build or why it was
   skipped (this host's decoder is then PIL);
12. ``parallel/`` (``parallel_*`` lines): NCCL with one rank per card, a
   group of one in this process: DP ``embed``/``extract`` at 48 x 1080p at
   DEFAULT and HIGHEST bit-equal to the single-device call (K1, K5 and K4,
   or K6a and K10, launched; K7 not), ``embed_spatial``/``extract_spatial``
   of one 4K image at HIGHEST within one u8 step of the single-device embed
   on under 2% of values and above 6 sigma, the corpus-sharded bench at its
   defaults (32 4K images, chunks of 8, HIGHEST; own marks above 6 sigma,
   others below; K7 launched) and one of its chunks timed by parts; then
   gloo ranks that all compute on this card (NCCL refuses two ranks on one
   card), spawned with ``parallel.launch.run_ranks``: DP (4, 1) at 1080p
   bit-equal at DEFAULT and HIGHEST, spatial (1, 4) at 1080p and at 1081 x
   1918, the corpus (2, 2) at height 1083 (padding rows zero, within one
   step on under 10%, 99% of values within 5e-2 of the single-device read),
   the staged embed on 3 ranks bit-equal at DEFAULT and HIGH (HIGHEST
   refused), and ``dryrun_multichip(4, "cuda")``; every rank's kernel
   launches are recorded and K1, K4, K6a, K10 and K3's plane and f32 modes
   (and not K7) must have launched inside the DP ranks, K7 in the corpus
   ranks (its write-back), K3's key mode in the spatial and corpus ranks
   (and the NCCL paths), and in the staged embed each run's own counts must
   show K1's single mode (DEFAULT) or its high mode (HIGH) on stage 0 and
   not the other, K3's plane mode on stage 1, K4 on stage 2.

The device line also reports, for information only, which of PIL, the
libjpeg and libpng headers, ``Python.h`` and ``g++`` the machine has (the
native builds need them).

The line before the last is the kernels' JSON record, each kernel with its
time, its plain version's, its bound (the larger of its operations over the
card's peak for their type and its bytes over the memory rate, from this
run's shapes) and one library call's time where one computes the same
function; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time

import numpy as np

N = 1000
SIGMA = 6.0
# Rounds of each stage breakdown kept after a warm-up round; the median is
# logged.
STAGE_ROUNDS = 3
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


@functools.lru_cache(maxsize=8)
def _texture_batch(seed: int, b: int, h: int, w: int) -> np.ndarray:
    """(b, h, w, 3) u8 textures, kept so that phases on the same seed (each
    fast tier at both rank generations; K9's and K10's phases) make them
    once."""
    rng = np.random.default_rng(seed)
    return np.stack([pink_texture(rng, h, w) for _ in range(b)])


def textures(seed: int, b: int, h: int, w: int):
    import torch

    return torch.from_numpy(_texture_batch(seed, b, h, w)).cuda()


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


def peak_mb(fn) -> float:
    """MB of device memory that one call of ``fn`` allocates at its peak
    above what was allocated before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e6


def _host_tools() -> dict:
    """Which of PIL, the libjpeg and libpng headers, ``Python.h`` and
    ``g++`` the host running this script has, as the native codec's build
    would find them: ``g++`` preprocessing an include of each header."""
    import importlib.util
    import shutil
    import sysconfig

    gxx = shutil.which("g++")

    def finds(header: str, *flags: str) -> bool:
        if gxx is None:
            return False
        src = f"#include <cstdio>\n#include <{header}>\n"
        return subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", "/dev/null",
                               *flags], input=src, capture_output=True,
                              text=True).returncode == 0

    return {"pil": importlib.util.find_spec("PIL") is not None,
            "gxx": gxx is not None, "jpeglib_h": finds("jpeglib.h"),
            "png_h": finds("png.h"),
            "python_h": finds("Python.h",
                              "-I" + sysconfig.get_paths()["include"])}


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch

    from spread_spectrum_watermarking_torch.kernels import _build

    print(_card(), flush=True)
    _build.library()
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        build_seconds=_build.BUILD_INFO["seconds"],
        build_cached=_build.BUILD_INFO["cached"])
    log("host_tools", **_host_tools())


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
    """u8 textures and the real embed path's (delta, idx) for them: K4's
    inputs."""
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
    return rgb, new - vals, idx


def _compare_k4(rgb, delta, idx) -> int:
    """K4's factor tile pass bit-equal to its plain version, and the whole
    kernel against its plain version; logs, raises past one u8 step,
    returns the largest step."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4

    h, w = rgb.shape[1:3]
    tiles_equal = all(
        torch.equal(t, r) for t, r in zip(
            k4.factor_tiles(delta, idx, h, w),
            k4.factor_tiles_reference(delta, idx, h, w)))
    t = k4.embed_epilogue(rgb, delta, idx).int()
    r = k4.embed_epilogue_reference(rgb, delta, idx).int()
    d = (t - r).abs()
    log("k4", shape=list(rgb.shape[:3]), n=N, factor_tiles_bit_equal=tiles_equal,
        share_differing=float((d > 0).float().mean()), max_abs_err=int(d.max()),
        share_changed=float((r != rgb.int()).float().mean()))
    if not tiles_equal:
        raise AssertionError("K4: the factor tiles differ from their plain "
                             "version")
    if int(d.max()) > 1:
        raise AssertionError("K4: more than one u8 step from its plain version")
    return int(d.max())


def phase_k4() -> dict:
    """K4 on the real path's inputs at 4 x and 48 x 1080p, its time, its
    plain version's, its bound, and one bf16 matmul of the factors: the
    record of ``embed_epilogue``."""
    from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
    from spread_spectrum_watermarking_torch.ops import dct

    worst = _compare_k4(*_epilogue_inputs(4, 1080, 1920))
    rgb, delta, idx = _epilogue_inputs(48, 1080, 1920)  # the main path's shape
    worst = max(worst, _compare_k4(rgb, delta, idx))
    bsz, h, w = rgb.shape[:3]
    a, b = dct.sparse_idct_factors(delta, idx, h, w)
    at = a.transpose(-1, -2)
    ms = time_ms(lambda: k4.embed_epilogue(rgb, delta, idx), 5)
    plain = time_ms(lambda: k4.embed_epilogue_reference(rgb, delta, idx), 5)
    # No one library call computes the function; the product alone is.
    product = time_ms(lambda: dct.matmul_bf16(at, b), 5)
    # An (H, n) @ (n, W) product per image; u8 in and out, the updates and
    # their int64 indices, the two f32 inverse bases.
    bd = bound(2 * bsz * h * w * N,
               6 * bsz * h * w + 12 * bsz * N + 4 * (h * h + w * w), BF16_PEAK)
    log("k4_time", shape=[48, 1080, 1920], n=N, ms=ms, plain_ms=plain,
        product_matmul_ms=product, share_of_bound=bd["bound_ms"] / ms, **bd)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "library_ms": None, **bd}


def _compare_k5(case: str, derived, base, idx) -> float:
    """K5 on one pair against its plain version, through both of
    ``read_tail.gates``: within ``k5_bound``, and an f64 error (in units of
    2^-24 times the two sums' absolute terms) at most twice the plain
    version's plus one unit; logs the readings, raises outside either gate,
    returns max |err|."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import read_tail as k5

    t = k5.read_tail(derived, base, idx)
    torch.cuda.synchronize()
    g = k5.gates(t, derived, base, idx)
    log("k5", case=case, shape=list(derived.shape[:3]), n=idx.shape[-1], **g)
    if not (g["within_bound"] and g["within_f64"] and g["finite"]):
        raise AssertionError(f"K5 {case} {tuple(derived.shape)}: outside "
                             "its gates")
    return g["max_abs_err"]


def _k5_pairs(base):
    """The derived images K5 is held on, from small to full-range
    differences: ±3 noise, a 12.5% resize round-trip, the half-size centre
    crop composited on black, an unrelated random image."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(base.shape[1])
    yield "noise3", (base.int() + torch.randint(
        -3, 4, base.shape, generator=gen, device="cuda")).clamp(
            0, 255).to(torch.uint8)
    h, w = base.shape[1:3]
    x = base.permute(0, 3, 1, 2).float()
    small = F.interpolate(x, size=(max(h // 8, 1), max(w // 8, 1)),
                          mode="bilinear", antialias=True)
    back = F.interpolate(small, size=(h, w), mode="bilinear")
    yield "resize_12.5", back.round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).contiguous()
    del x, small, back
    crop = torch.zeros_like(base)
    crop[:, h // 4:h // 4 + h // 2, w // 4:w // 4 + w // 2] = \
        base[:, h // 4:h // 4 + h // 2, w // 4:w // 4 + w // 2]
    yield "crop_black", crop
    yield "unrelated", torch.randint(0, 256, base.shape, generator=gen,
                                     device="cuda", dtype=torch.uint8)


def _k5_device(fn, calls: int = 3) -> dict:
    """From torch.profiler over ``calls`` calls after a warm-up: the device
    launches recorded per call, and each kernel's [mean device ms a
    launch, launches recorded] (a launch the profiler failed to record
    shows as a count short of ``calls``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            rec = per.setdefault(name.split("<")[0].split("(")[0], [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
    return {"device_launches_per_call": sum(n for _, n in per.values())
            / calls, "device_ms": {k: [ms / n, n] for k, (ms, n) in
                                   per.items()}}


def _k5_timing(marked, base, idx) -> dict:
    """K5 on one pair: its ms and its plain version's (CUDA events, mean
    of 5 after a warm-up), its device launches a call and each kernel's
    device ms (``_k5_device``), the peak of memory one call allocates
    (scratch and output, ``peak_scratch_mb``), the distinct first-pass
    rows the indices need and its bound from them. Only ``read_tail`` and
    its plain version are called, so any checkout's port can be timed so
    (``scripts/k5_ab.py``)."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import read_tail as k5

    b, h, w = marked.shape[:3]
    n = idx.shape[-1]
    rec = {"ms": time_ms(lambda: k5.read_tail(marked, base, idx), 5),
           "plain_ms": time_ms(
               lambda: k5.read_tail_reference(marked, base, idx), 5),
           **_k5_device(lambda: k5.read_tail(marked, base, idx))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    k5.read_tail(marked, base, idx)
    torch.cuda.synchronize()
    rec["peak_scratch_mb"] = (torch.cuda.max_memory_allocated()
                              - before) / 1e6
    px, s, l = b * h * w, min(h, w), max(h, w)
    # The function needs one first-pass row, S L long, per distinct
    # (image, coordinate along S) of the indices, and an L-long dot per
    # index; two u8 images in, the int64 indices in, f32 out, the two bf16
    # bases.
    a = (idx // w if h <= w else idx % w).expand(b, n).sort(-1).values
    rows = b + int((a.diff(dim=-1) != 0).sum())
    rec.update(distinct_rows=rows, **bound(
        2 * rows * s * l + 2 * b * n * l,
        6 * px + 12 * b * n + 2 * (s * s + l * l), BF16_PEAK))
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    return rec


def k5_inputs(content: str, seed: int, b: int, h: int, w: int):
    """(marked, base, idx) as the fast tiers read them: ``base`` the 1/f
    textures of ``seed`` (``textures``) or the harness's random u8
    (``bench._inputs`` from numpy's generator of ``seed``), marked by
    ``embed`` at DEFAULT with n = 1000 marks, ``idx`` its ranked indices
    from ``rank_base``."""
    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import Precision, bench

    if content == "random_u8":
        base, marks = bench._inputs(np.random.default_rng(seed), b, h, w, N,
                                    torch.device("cuda"))
    else:
        base = textures(seed, b, h, w)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        marks = torch.randn((b, 1, N), generator=gen, device="cuda")
    marked = wm.embed(base, marks, wm.WriteConfig(precision=Precision.DEFAULT))
    idx, _ = wm.rank_base(base, N, wm.ReadConfig(precision=Precision.DEFAULT))
    return marked, base, idx


def phase_k5() -> dict:
    """K5 (the read tail) against its plain version through both of
    ``read_tail.gates`` (within ``k5_bound``; the f64 error):
    at 48 x 1080p on the main path's marked pair (DEFAULT, n = 1000 ranked
    indices) and on ±3 noise, a resize round-trip, a crop-to-black
    composite and an unrelated image; at 8 x 4K and 4 x 1920 x 1080
    (portrait) on the marked and the unrelated pairs; on the harness's
    random u8, marked and ranked the same way, at 48 x 1080p and 8 x 4K; at
    444 x 640, 640 x 444 and 37 x 59 at n = 1, 1000 and 20,000 (indices
    with repeats); then its time (``_k5_timing``) at 48 x 1080p and 8 x 4K
    on the textures and on random u8, and on the textures beside the old
    route's (K1's pair mode, then the plain gather-dot): the record of
    ``read_tail``, from the 48 x 1080p random u8, the harness's rate
    inputs."""
    import torch

    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1
    from spread_spectrum_watermarking_torch.ops import dct

    gen = torch.Generator(device="cuda").manual_seed(55)
    worst, times = 0.0, {}
    # The main path's and phase 9's textures (seeds 30 and 50), a portrait
    # batch, and the harness's random u8 (seed 0) at both sizes.
    for content, seed, b, h, w in (("textures", 30, 48, 1080, 1920),
                                   ("textures", 50, 8, 2160, 3840),
                                   ("textures", 65, 4, 1920, 1080),
                                   ("random_u8", 0, 48, 1080, 1920),
                                   ("random_u8", 0, 8, 2160, 3840)):
        marked, base, idx = k5_inputs(content, seed, b, h, w)
        tag = "marked" if content == "textures" else "random_u8"
        worst = max(worst, _compare_k5(tag, marked, base, idx))
        if content == "textures":
            for case, derived in _k5_pairs(base):
                if b == 48 or case == "unrelated":
                    worst = max(worst, _compare_k5(case, derived, base, idx))
                del derived
        if b in (48, 8):
            rec = _k5_timing(marked, base, idx)
            if content == "textures":
                ax = dct.shorter_axis(h, w)
                td = k1.luma_pass(marked, base)
                rec.update(
                    old_route_ms=time_ms(lambda: dct.dct2_dot_at(
                        k1.luma_pass(marked, base), idx, contracted_axis=ax,
                        precision=Precision.DEFAULT), 5),
                    old_k1_pair_ms=time_ms(
                        lambda: k1.luma_pass(marked, base), 5),
                    old_gather_dot_ms=time_ms(lambda: dct.dct2_dot_at(
                        td, idx, contracted_axis=ax,
                        precision=Precision.DEFAULT), 5))
                del td
            times[content, b] = rec
            log("k5_time", content=content, shape=[b, h, w], n=N, **rec)
            if rec["device_launches_per_call"] > 4:
                raise AssertionError("K5 makes more than 4 device launches")
        del base, marked, idx
        torch.cuda.empty_cache()
    for h, w in ((444, 640), (640, 444), (37, 59)):
        base = textures(70 + h, 2, h, w)
        for n in (1, 1000, 20000):
            idx = torch.randint(0, h * w, (2, n), generator=gen,
                                device="cuda")
            for case, derived in _k5_pairs(base):
                if case in ("noise3", "unrelated"):
                    worst = max(worst, _compare_k5(case, derived, base, idx))
    rec = times["random_u8", 48]
    return {"max_abs_err": worst, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "library_ms": None, "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"]}


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
        ms = time_ms(lambda: k7.add_quantize(rgb, dy, quantize), 5)
        fields.update({
            f"{mode}_ms": ms,
            f"{mode}_plain_ms": time_ms(
                lambda: k7.add_quantize_reference(rgb, dy, quantize), 3),
            f"{mode}_share_of_bound": bd["bound_ms"] / ms,
            **{f"{mode}_{key}": v for key, v in bd.items()}})
    # The form the card ran before K7: product and sum rounded apart.
    fields["two_rounding_ms"] = time_ms(lambda: colorspace.f32_to_u8(
        torch.clamp(colorspace.u8_to_f32(rgb) + dy[..., None], 0.0, 1.0)), 3)
    log("k7", shape=[48, 1080, 1920], bit_equal_u8=True, bit_equal_f32=True,
        **fields)
    return {"max_abs_err": 0.0, "ms": fields["u8_ms"],
            "plain_ms": fields["u8_plain_ms"], "library_ms": None,
            "bound_ms": fields["u8_bound_ms"], "bound_by": fields["u8_bound_by"]}


def _k3_check(tag: str, got, want, **fields) -> None:
    """K3's outputs index for index (f32 estimates bit for bit) equal to its
    plain version's; logs, raises where they differ."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    bits = [(g.view(torch.int32), w.view(torch.int32))
            if g.dtype == torch.float32 else (g, w) for g, w in zip(got, want)]
    equal = all(torch.equal(g, w) for g, w in bits)
    log("k3", case=tag, index_equal=equal, **fields)
    if not equal:
        raise AssertionError(f"K3 {tag}: differs from its plain version")


def _k3_issue(fn):
    """``(out, fields)``: one K3 call after a warm-up call, with the device
    launches it made (``LAST_DEVICE_LAUNCHES``) and the host's microseconds
    to issue it (no sync inside)."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import topk_select as k3

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    host_us = (time.perf_counter() - t0) * 1e6
    return out, {"device_launches": k3.LAST_DEVICE_LAUNCHES,
                 "host_issue_us": host_us}


def _composite_topk(key, pos=None):
    """``fn()``: one ``torch.topk`` over K3's int64 composites, built
    beforehand (the library call the kernel is timed against)."""
    import torch

    if pos is None:
        pos = torch.arange(key.shape[-1], device=key.device)
    comp = (key.to(torch.int64) << 32) | (2 ** 31 - 1 - pos)
    return lambda: torch.topk(comp, N, dim=-1, sorted=True)


def phase_k3() -> tuple[dict, dict, dict]:
    """K3 index for index (estimates bit for bit) against its plain
    versions on the card, each call logged with its device launches and
    the host's microseconds to issue it: the plane mode (generation 2's
    select, re-sort and estimates in one call) on the main path's 48 x 1080
    x 1920 bf16 plane at each ordering; the f32 mode on HIGHEST's f32
    coefficients (48 x 1080p, K6a on the luma) at ENERGY and
    ENERGY_ORTHOGONAL, also against the key mode over the key plane and the
    tiled route; the key mode on that int32 key plane, on generation 1's
    re-sort (48, n) with the selected flat indices as positions and on the
    tiled route's (48, 32 n) tile-ordered candidates; a row of equal keys
    (positions along the row and permuted), int32 extremes, n = 1 and
    n = L on a 37 x 59 plane; n = 20,000 (the multi-pass path) in each
    mode. ``top_indices`` at HIGHEST ENERGY must raise the peak of
    allocated memory by less than one f32 plane. Then each mode's time
    beside its plain version's, one ``torch.topk`` on prebuilt composites
    and its bound (one read of the input, one write of the output): the
    records of ``topk_select``, ``topk_select_plane`` and
    ``topk_select_coeffs``."""
    import torch

    from spread_spectrum_watermarking_torch import Ordering, Precision
    from spread_spectrum_watermarking_torch.kernels import topk_select as k3
    from spread_spectrum_watermarking_torch.models import pipeline as tp
    from spread_spectrum_watermarking_torch.ops import colorspace, dct, ranking

    def plane_of(rgb):
        ax = dct.shorter_axis(rgb.shape[1], rgb.shape[2])
        return tp._second_pass(tp._half_pass(rgb, Precision.DEFAULT), ax)

    energy, ortho = Ordering.ENERGY, Ordering.ENERGY_ORTHOGONAL
    plane = plane_of(textures(30, 48, 1080, 1920))  # the main path's
    shape = list(plane.shape)
    for o in Ordering:
        got, issue = _k3_issue(lambda: k3.top_of_plane(plane, N, o))
        _k3_check(f"plane_{o.value}", got,
                  k3.top_of_plane_reference(plane, N, o), shape=shape, n=N,
                  **issue)
    idx, kv = k3.plane_set_reference(plane, N, energy)
    order_key = torch.where(idx == 0, ranking._DC_KEY, kv & 0xFFFE)
    got, issue = _k3_issue(lambda: k3.top_by_key(order_key, idx, N))
    _k3_check("resort", got, k3.top_by_key_reference(order_key, idx, N),
              shape=[48, N], n=N, **issue)
    for o in Ordering:
        got, issue = _k3_issue(lambda: k3.top_of_plane(plane[:8], 20000, o))
        _k3_check(f"plane_n_20000_{o.value}", got,
                  k3.top_of_plane_reference(plane[:8], 20000, o),
                  shape=[8, 1080, 1920], n=20000, **issue)
    b, h, w = plane.shape
    times = {
        "plane_ms": time_ms(lambda: k3.top_of_plane(plane, N, energy), 20),
        "plane_plain_ms": time_ms(
            lambda: k3.top_of_plane_reference(plane, N, energy), 5),
        "plane_library_ms": time_ms(
            _composite_topk(k3.plane_keys(plane, energy)), 5),
        "resort_ms": time_ms(lambda: k3.top_by_key(order_key, idx, N), 20),
        "resort_plain_ms": time_ms(
            lambda: k3.top_by_key_reference(order_key, idx, N), 20),
        "resort_library_ms": time_ms(_composite_topk(order_key, idx), 20)}
    # Bytes: the input read once (bf16 or f32 plane; int32 keys and int64
    # positions), the int64 positions (and the plane mode's f32 estimates)
    # written once. The few integer operations an element are not counted.
    bounds = {"plane": bound(0, 2 * plane.numel() + 12 * b * N, BF16_PEAK),
              "resort": bound(0, 12 * b * N + 8 * b * N, BF16_PEAK)}
    del plane, idx, kv, order_key
    torch.cuda.empty_cache()

    small = plane_of(textures(31, 2, 37, 59))
    size = 37 * 59
    for o in Ordering:
        for n in (1, size):
            got, issue = _k3_issue(lambda: k3.top_of_plane(small, n, o))
            _k3_check(f"plane_37x59_{o.value}_n{n}", got,
                      k3.top_of_plane_reference(small, n, o), n=n, **issue)
    small_key = k3.plane_keys(small, energy)
    small_c = small.float()
    for n in (1, size):
        got, issue = _k3_issue(lambda: k3.top_by_key(small_key, None, n))
        _k3_check(f"keys_37x59_n{n}", got,
                  k3.top_by_key_reference(small_key, None, n), n=n, **issue)
        for o in (energy, ortho):
            got, issue = _k3_issue(lambda: k3.top_of_coeffs(small_c, n, o))
            _k3_check(f"coeffs_37x59_{o.value}_n{n}", got,
                      k3.top_of_coeffs_reference(small_c, n, o), n=n, **issue)

    # HIGHEST's f32 coefficients, from its own path's pieces (K6a on the
    # luma), and the int32 key plane the key mode selects over.
    c = dct.dct2_2d(colorspace.luma(textures(60, 48, 1080, 1920)))
    for o in (energy, ortho):
        got, issue = _k3_issue(lambda: k3.top_of_coeffs(c, N, o))
        _k3_check(f"coeffs_{o.value}", got,
                  k3.top_of_coeffs_reference(c, N, o), shape=list(c.shape),
                  n=N, **issue)
        got, issue = _k3_issue(lambda: k3.top_of_coeffs(c[:8], 20000, o))
        _k3_check(f"coeffs_n_20000_{o.value}", got,
                  k3.top_of_coeffs_reference(c[:8], 20000, o), n=20000,
                  **issue)
    # top_indices at HIGHEST ENERGY writes no metric or key plane: the peak
    # rises by the scratch and the output only.
    plane_bytes = 4 * c.numel()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    coeff_idx = ranking.top_indices(c, N, energy)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    k3.top_of_coeffs_reference(c, N, energy)
    torch.cuda.synchronize()
    plain_rise = torch.cuda.max_memory_allocated() - before
    log("k3_memory", shape=list(c.shape), f32_plane_bytes=plane_bytes,
        top_indices_peak_rise_bytes=rise, plain_peak_rise_bytes=plain_rise)
    if not rise < plane_bytes:
        raise AssertionError(f"top_indices at HIGHEST ENERGY raised the "
                             f"peak by {rise} bytes, a plane is {plane_bytes}")
    key = ranking._f32_key(ranking.ranking_metric(c, energy).reshape(
        48, -1).contiguous())
    key[..., 0] = ranking._NEG_INF_KEY
    tiled = ranking._tiled_top(key, N, 32)
    got, issue = _k3_issue(lambda: k3.top_by_key(key, None, N))
    _k3_check("highest_keys", got, k3.top_by_key_reference(key, None, N),
              shape=list(key.shape), n=N, **issue)
    _k3_check("highest_keys_vs_tiled_route", got, tiled, n=N)
    _k3_check("highest_coeffs_vs_key_mode", coeff_idx, got, n=N)
    got, issue = _k3_issue(lambda: k3.top_by_key(key[:8], None, 20000))
    _k3_check("highest_keys_n_20000", got,
              k3.top_by_key_reference(key[:8], None, 20000), n=20000, **issue)
    # The tiled route's candidates: the n tiles of 32 its recursion picks.
    tiles = key.reshape(48, -1, 32)
    tile_ids = ranking._tiled_top(tiles.amax(-1), N, 32)
    cand = ranking._zeros_tie(torch.gather(
        tiles, 1, tile_ids[..., None].expand(48, N, 32)).reshape(48, -1))
    cand_idx = (tile_ids[..., None] * 32
                + torch.arange(32, device="cuda")).reshape(48, -1)
    got, issue = _k3_issue(lambda: k3.top_by_key(cand, cand_idx, N))
    _k3_check("tiled_candidates", got,
              k3.top_by_key_reference(cand, cand_idx, N),
              shape=list(cand.shape), n=N, **issue)
    times.update({
        "highest_keys_ms": time_ms(lambda: k3.top_by_key(key, None, N), 20),
        "highest_keys_plain_ms": time_ms(
            lambda: k3.top_by_key_reference(key, None, N), 5),
        "highest_keys_library_ms": time_ms(_composite_topk(key), 5),
        "highest_tiled_route_ms": time_ms(
            lambda: ranking._tiled_top(key, N, 32), 5),
        "coeffs_ms": time_ms(lambda: k3.top_of_coeffs(c, N, energy), 20),
        "coeffs_ortho_ms": time_ms(lambda: k3.top_of_coeffs(c, N, ortho),
                                   20),
        "coeffs_plain_ms": time_ms(
            lambda: k3.top_of_coeffs_reference(c, N, energy), 5)})
    times["coeffs_library_ms"] = times["highest_keys_library_ms"]
    bounds["highest_keys"] = bound(0, 4 * key.numel() + 8 * 48 * N,
                                   BF16_PEAK)
    bounds["coeffs"] = bound(0, 4 * c.numel() + 8 * 48 * N, F32_PEAK)
    del key, tiles, cand, cand_idx, c, coeff_idx
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(14)
    equal = torch.full((4, 1_000_000), 7, dtype=torch.int32, device="cuda")
    perm = torch.stack([torch.randperm(1_000_000, generator=gen,
                                       device="cuda") for _ in range(4)])
    got, issue = _k3_issue(lambda: k3.top_by_key(equal, None, N))
    _k3_check("equal_keys", got, k3.top_by_key_reference(equal, None, N),
              shape=[4, 1_000_000], **issue)
    got, issue = _k3_issue(lambda: k3.top_by_key(equal, perm * 3 + 1, N))
    _k3_check("equal_keys_permuted_pos", got,
              k3.top_by_key_reference(equal, perm * 3 + 1, N),
              shape=[4, 1_000_000], **issue)
    ends = torch.tensor([-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 2 ** 31 - 2,
                         2 ** 31 - 1], dtype=torch.int32, device="cuda")
    extremes = ends[torch.randint(0, 7, (4, 1_000_000), generator=gen,
                                  device="cuda")]
    got, issue = _k3_issue(lambda: k3.top_by_key(extremes, None, N))
    _k3_check("int32_extremes", got,
              k3.top_by_key_reference(extremes, None, N),
              shape=[4, 1_000_000], **issue)
    log("k3_time", card=_card(), shape=shape, n=N, **times,
        **{f"{name}_{k}": v for name, bd in bounds.items()
           for k, v in bd.items()})
    return ({"max_abs_err": 0, "ms": times["highest_keys_ms"],
             "plain_ms": times["highest_keys_plain_ms"],
             "library_ms": times["highest_keys_library_ms"],
             **bounds["highest_keys"]},
            {"max_abs_err": 0, "ms": times["plane_ms"],
             "plain_ms": times["plane_plain_ms"],
             "library_ms": times["plane_library_ms"], **bounds["plane"]},
            {"max_abs_err": 0, "ms": times["coeffs_ms"],
             "plain_ms": times["coeffs_plain_ms"],
             "library_ms": times["coeffs_library_ms"], **bounds["coeffs"]})


def _k8_check(case: str, rgb) -> None:
    """K8 on ``rgb`` bit-equal to its plain version (the table); one launch
    counted; logs, raises otherwise."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import luma_u8 as k8

    before = k8.LAUNCHES
    t = k8.luma_u8(rgb)
    torch.cuda.synchronize()
    r = k8.luma_u8_reference(rgb)
    equal = t.shape == r.shape and torch.equal(t.view(torch.int32),
                                               r.view(torch.int32))
    log("k8", case=case, shape=list(rgb.shape), strides=list(rgb.stride()),
        bit_equal=equal, launches=k8.LAUNCHES - before)
    if not equal or k8.LAUNCHES != before + 1:
        raise AssertionError(f"K8 {case}: not bit-equal to the table, or "
                             "not launched once")


def phase_k8() -> dict:
    """K8 (the u8 luma) bit-equal to its plain version, the table of every
    colour's luma: over one 4096 x 4096 image that holds every colour, at
    48 x 1080p on the harness's random u8 and on 1/f textures, in portrait
    (8 x 1920 x 1080), on a strided view and on an image one byte into its
    storage (the byte loads); its time at 48 x 1080p on both contents
    beside the table's, its bound and the peak memory of a call beside the
    table's: the record of ``luma_u8``, from the random u8."""
    import torch

    from spread_spectrum_watermarking_torch import bench
    from spread_spectrum_watermarking_torch.kernels import luma_u8 as k8

    v = torch.arange(1 << 24, dtype=torch.int32, device="cuda")
    every = torch.stack([v >> 16, (v >> 8) & 255, v & 255], -1).to(
        torch.uint8).reshape(4096, 4096, 3)
    _k8_check("every_colour", every)
    del v, every
    rand, _ = bench._inputs(np.random.default_rng(0), 48, 1080, 1920, N,
                            torch.device("cuda"))
    tex = textures(60, 48, 1080, 1920)
    _k8_check("random_u8", rand)
    _k8_check("textures", tex)
    gen = torch.Generator(device="cuda").manual_seed(81)
    portrait = torch.randint(0, 256, (8, 1920, 1080, 3), generator=gen,
                             device="cuda", dtype=torch.uint8)
    _k8_check("portrait", portrait)
    _k8_check("strided", rand[:6, 3::2, 5::3])
    odd = torch.empty(portrait.numel() + 1, dtype=torch.uint8,
                      device="cuda")[1:].view(portrait.shape)
    odd.copy_(portrait)
    _k8_check("one_byte_in", odd)
    del portrait, odd
    fields = {}
    px = rand.numel() // 3
    # u8 in, f32 out; a few operations a pixel.
    bd = bound(6 * px, 3 * px + 4 * px, F32_PEAK)
    for content, x in (("random_u8", rand), ("textures", tex)):
        ms = time_ms(lambda: k8.luma_u8(x), 10)
        fields[content] = {"ms": ms, "plain_ms": time_ms(
            lambda: k8.luma_u8_reference(x), 5), "share_of_bound":
            bd["bound_ms"] / ms}
    log("k8_time", shape=[48, 1080, 1920], **fields, **bd,
        kernel_peak_mb=peak_mb(lambda: k8.luma_u8(rand)),
        table_peak_mb=peak_mb(lambda: k8.luma_u8_reference(rand)))
    rec = fields["random_u8"]
    return {"max_abs_err": 0.0, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "library_ms": None, **bd}


def k9_inputs(content: str, seed: int, b: int, h: int, w: int):
    """(y, idx) as the HIGHEST read takes them: ``base`` the 1/f textures
    of ``seed`` or the harness's random u8 (``bench._inputs`` from numpy's
    generator of ``seed``), marked by ``embed`` at HIGHEST with n = 1000
    marks; ``y`` the marked image's luma, ``idx`` the base's ranked
    indices from ``prepare_base``."""
    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import bench
    from spread_spectrum_watermarking_torch.ops import colorspace

    if content == "random_u8":
        base, marks = bench._inputs(np.random.default_rng(seed), b, h, w, N,
                                    torch.device("cuda"))
    else:
        base = textures(seed, b, h, w)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        marks = torch.randn((b, 1, N), generator=gen, device="cuda")
    marked = wm.embed(base, marks)
    idx = wm.prepare_base(base, N)[1]
    return colorspace.luma(marked), idx


def _compare_k9(case: str, y, idx, strict: bool) -> float:
    """K9 on ``(y, idx)`` against its plain version through
    ``highest_read.gates`` (within ``k9_bound``; an f64 error at most the
    plain version's plus one pass's split term) and, where ``strict``, an
    f64 error no
    larger than the plain route's (cuBLAS's f32 pass and the gather-dot);
    logs the readings, raises outside a gate, returns max |err|."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import highest_read as k9

    t = k9.highest_read(y, idx)
    torch.cuda.synchronize()
    g = k9.gates(t, y, idx)
    log("k9", case=case, shape=list(y.shape), n=idx.shape[-1], **g)
    if not (g["within_bound"] and g["within_f64"] and g["finite"]
            and (g["no_worse_than_plain"] or not strict)):
        raise AssertionError(f"K9 {case} {tuple(y.shape)}: outside its gates")
    return g["max_abs_err"]


def _k9_timing(y, idx) -> dict:
    """K9 on one input: its ms, its plain version's and the library's (one
    f32 ``torch.matmul`` pass over the whole shorter axis, TF32 off, the
    plain version's first part), its device launches a call and each
    kernel's device ms, the peak memory of a call and of the plain
    version's, the distinct first-pass rows the indices need and the bound
    from them."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import highest_read as k9
    from spread_spectrum_watermarking_torch.ops import dct

    b, h, w = y.shape
    s = min(h, w)
    cs = dct.basis_tensor(s, y.device, torch.float32)
    rec = {"ms": time_ms(lambda: k9.highest_read(y, idx), 5),
           "plain_ms": time_ms(lambda: k9.highest_read_reference(y, idx), 5),
           "library_ms": time_ms(lambda: dct.matmul_f32(cs, y) if h <= w
                                 else dct.matmul_f32(y, cs.t()), 5),
           **_k5_device(lambda: k9.highest_read(y, idx)),
           "peak_mb": peak_mb(lambda: k9.highest_read(y, idx)),
           "plain_peak_mb": peak_mb(
               lambda: k9.highest_read_reference(y, idx)),
           **k9_bound_ms(y, idx)}
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    rec.update(k9_pass_share(rec))
    return rec


#: K9's design, as the k9_time lines name it (csrc/highest_read.cu).
K9_DESIGN = ("compaction; first pass at the distinct rows: 64-slot by "
             "192-position tiles walked persistently over live tiles, a TMA "
             "and cp.async producer warpgroup on mbarriers, 3xTF32 "
             "wgmma.m64n64k8 with each k-step's f32 add overlapped with the "
             "next step's products; f32 dots")


def k9_pass_share(rec: dict) -> dict:
    """The first pass's device ms (``pass_ms``, from ``rec['device_ms']``)
    and its share of its own bound (``pass_share_of_bound``: the TF32
    operations of the distinct rows, ``pass_bound_ms``)."""
    ms = [v[0] for k, v in rec["device_ms"].items() if "pass_kernel" in k]
    if not ms:
        return {"pass_ms": None, "pass_share_of_bound": None}
    return {"pass_ms": ms[0],
            "pass_share_of_bound": rec["pass_bound_ms"] / ms[0]}


def k9_bound_ms(y, idx) -> dict:
    """K9's bound on ``(y, idx)`` (``distinct_rows``, ``bound_ms``,
    ``bound_by``): one first-pass row, S L long, per distinct (image,
    coordinate along S), three TF32 products each; an L-long f32 dot per
    index. The f32 luma and the int64 indices in, f32 out; the bases (two
    TF32 parts of C_S, C_L)."""
    b, h, w = y.shape
    n = idx.shape[-1]
    s, l = min(h, w), max(h, w)
    a = (idx // w if h <= w else idx % w).expand(b, n).sort(-1).values
    rows = b + int((a.diff(dim=-1) != 0).sum())
    ops_ms = (3 * 2 * rows * s * l / TF32_PEAK
              + 2 * b * n * l / F32_PEAK) * 1e3
    bytes_ms = (4 * b * h * w + 12 * b * n + 4 * (2 * s * s + l * l)) \
        / HBM_RATE * 1e3
    # The first pass alone: its TF32 operations, or its read of the luma
    # and the bases' parts.
    pass_ms = max(3 * 2 * rows * s * l / TF32_PEAK,
                  (4 * b * h * w + 8 * s * s) / HBM_RATE) * 1e3
    return {"distinct_rows": rows, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "pass_bound_ms": pass_ms}


def phase_k9() -> dict:
    """K9 (the HIGHEST read: the compaction, the 3xTF32 first pass at the
    distinct rows, the dots) against its plain version
    (``dct.dct2_coeffs_at``) through ``highest_read.gates`` and an f64
    error no larger than the plain route's: at 48 x 1080p and 8 x 4K, in
    landscape and portrait, on 1/f textures and on the harness's random
    u8, each marked at HIGHEST with n = 1000 and read at the base's ranked
    indices; at 444 x 640, 640 x 444 and 37 x 59 at n = 1, 1000 and
    20,000 (random indices with repeats; the f64 comparison with the plain
    route is not required there, where either may read the closer on a
    few indices); then its time (``_k9_timing``) at 48 x 1080p and 8 x 4K
    on both contents: the record of ``highest_read``, from the 48 x 1080p
    random u8, the harness's rate inputs."""
    import torch

    from spread_spectrum_watermarking_torch.ops import colorspace

    worst, times = 0.0, {}
    for content in ("textures", "random_u8"):
        for b, h, w in ((48, 1080, 1920), (48, 1920, 1080),
                        (8, 2160, 3840), (8, 3840, 2160)):
            y, idx = k9_inputs(content, 90 + b + (h > w), b, h, w)
            worst = max(worst, _compare_k9(content, y, idx, True))
            if h <= w:
                rec = _k9_timing(y, idx)
                times[content, b] = rec
                log("k9_time", content=content, shape=[b, h, w], n=N,
                    design=K9_DESIGN, **rec)
                if rec["device_launches_per_call"] > 3:
                    raise AssertionError("K9 makes more than 3 device "
                                         "launches")
                if rec["peak_mb"] > rec["plain_peak_mb"]:
                    raise AssertionError("K9 takes more memory than the "
                                         "plain read")
            del y, idx
            torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(95)
    for h, w in ((444, 640), (640, 444), (37, 59)):
        y = colorspace.luma(textures(97 + h, 2, h, w))
        for n in (1, 1000, 20000):
            idx = torch.randint(0, h * w, (2, n), generator=gen,
                                device="cuda")
            worst = max(worst, _compare_k9("random_idx", y, idx, False))
    rec = times["random_u8", 48]
    return {"max_abs_err": worst, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "library_ms": rec["library_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"]}


def k10_inputs(content: str, seed: int, b: int, h: int, w: int):
    """(rgb, delta, idx) as the HIGHEST embed hands them to K10: ``rgb``
    the 1/f textures of ``seed`` or the harness's random u8
    (``bench._inputs`` from numpy's generator of ``seed``), ``idx`` its n =
    1000 ranked indices from ``prepare_base``, ``delta`` the updates of
    n = 1000 marks there at the default insertion."""
    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import bench
    from spread_spectrum_watermarking_torch.ops import modulation

    if content == "random_u8":
        base, marks = bench._inputs(np.random.default_rng(seed), b, h, w, N,
                                    torch.device("cuda"))
    else:
        base = textures(seed, b, h, w)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        marks = torch.randn((b, 1, N), generator=gen, device="cuda")
    flat, idx = wm.prepare_base(base, N)
    orig = torch.gather(flat, -1, idx)
    del flat
    ins = wm.WriteConfig().insertion
    delta = modulation.embed_marks(orig, marks, ins.method, ins.alpha) - orig
    return base, delta, idx


def _k10_views(rgb):
    """Views of ``rgb`` that take K10's other u8 epilogue paths than the
    contiguous image's (TMA boxes where rows of 3 W bytes lie on 16, as at
    1920 and 3840 wide; four-pixel word units at 1080): ``crop``, the image
    inside a border of 8 pixels (rows 3 (W + 16) bytes apart, its base 8
    bytes past a 16-byte boundary), which takes the word units at the
    view's strides, and ``one_byte_in``, a contiguous copy one byte into
    its storage, which takes the byte path."""
    import torch

    b, h, w, _ = rgb.shape
    big = torch.zeros((b, h + 16, w + 16, 3), dtype=rgb.dtype,
                      device=rgb.device)
    big[:, 8:-8, 8:-8] = rgb
    yield "crop", big[:, 8:-8, 8:-8]
    del big
    odd = torch.empty(rgb.numel() + 1, dtype=rgb.dtype,
                      device=rgb.device)[1:].view(rgb.shape)
    odd.copy_(rgb)
    yield "one_byte_in", odd


def _compare_k10(case: str, rgb, delta, idx, strict: bool) -> float:
    """K10's two modes on ``(rgb, delta, idx)`` through
    ``highest_inverse.gates`` (dY within ``k10_bound``, an f64 error at
    most the plain version's plus one pass's split term and, where
    ``strict``, no larger than the plain route's; the u8 output K7's
    rounding of its own dY and within one step of the plain u8), a second
    call of each bit-identical, and the u8 mode on each of ``_k10_views``
    bit-identical to that gated output (so each epilogue path is held to
    the gates); logs the readings, raises outside a gate, returns max |err|
    of dY."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import highest_inverse as k10

    h, w = rgb.shape[1:3]
    dy = k10.sparse_delta(delta, idx, h, w)
    out = k10.highest_inverse(rgb, delta, idx)
    torch.cuda.synchronize()
    repeat = bool(torch.equal(dy, k10.sparse_delta(delta, idx, h, w))
                  and torch.equal(out, k10.highest_inverse(rgb, delta, idx)))
    views = {name: bool(torch.equal(k10.highest_inverse(v, delta, idx), out))
             for name, v in _k10_views(rgb)}
    g = k10.gates(dy, delta, idx, rgb, out)
    log("k10", case=case, shape=list(rgb.shape), n=idx.shape[-1],
        repeat_bit_equal=repeat, views_bit_equal=views, **g)
    if not (g["within_bound"] and g["within_f64"] and g["finite"]
            and g["u8_bit_equal_own_dy"] and g["max_u8_step_from_plain"] <= 1
            and repeat and all(views.values())
            and (g["no_worse_than_plain"] or not strict)):
        raise AssertionError(f"K10 {case} {tuple(rgb.shape)}: outside its "
                             "gates")
    return g["max_abs_err"]


def k10_bound_ms(rgb, idx) -> dict:
    """K10's bound on ``(rgb, idx)`` (``distinct_rows``, ``bound_ms``,
    ``bound_by``): the product's 2 S L multiply-adds per distinct (image,
    coordinate along S), three TF32 products each, and M's 2 L per index
    in f32; the u8 image in and out once, the updates and indices, the
    bases (D_S's two TF32 parts, D_L)."""
    b, h, w = rgb.shape[:3]
    n = idx.shape[-1]
    s, l = min(h, w), max(h, w)
    a = (idx // w if h <= w else idx % w).expand(b, n).sort(-1).values
    rows = b + int((a.diff(dim=-1) != 0).sum())
    ops_ms = (3 * 2 * rows * s * l / TF32_PEAK
              + 2 * b * n * l / F32_PEAK) * 1e3
    bytes_ms = (2 * rgb.numel() + 12 * b * n + 4 * (2 * s * s + l * l)) \
        / HBM_RATE * 1e3
    return {"distinct_rows": rows, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _k10_timing(rgb, delta, idx) -> dict:
    """K10 on one input: its ms in u8 mode and in dY mode, its plain
    version's (the f32 cuBLAS product, then K7's plain rounding), the
    route the card ran before it (the factors, the product, then K7) and
    the library's (one f32 ``torch.matmul`` of prebuilt factors, TF32 off:
    the product alone), its device launches a call and each kernel's device
    ms, the peak memory of a call and of the old route's, and the bound
    from the distinct rows with K10's share of it and its pass's."""
    from spread_spectrum_watermarking_torch.kernels import highest_inverse as k10
    from spread_spectrum_watermarking_torch.kernels.add_quantize import (
        add_quantize)
    from spread_spectrum_watermarking_torch.ops import dct

    h, w = rgb.shape[1:3]

    def old_route():
        return add_quantize(rgb, k10.sparse_delta_reference(delta, idx, h, w),
                            True)

    a, b = dct.sparse_factors_f32(delta, idx, h, w)
    rec = {"ms": time_ms(lambda: k10.highest_inverse(rgb, delta, idx), 5),
           "dy_mode_ms": time_ms(lambda: k10.sparse_delta(delta, idx, h, w),
                                 5),
           "plain_ms": time_ms(
               lambda: k10.highest_inverse_reference(rgb, delta, idx), 3),
           "old_route_ms": time_ms(old_route, 5),
           "library_ms": time_ms(
               lambda: dct.matmul_f32(a.transpose(-1, -2), b), 5)}
    del a, b
    rec.update(**_k5_device(lambda: k10.highest_inverse(rgb, delta, idx)),
               peak_mb=peak_mb(lambda: k10.highest_inverse(rgb, delta, idx)),
               old_route_peak_mb=peak_mb(old_route), **k10_bound_ms(rgb, idx))
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    pass_ms = [ms for name, (ms, _) in rec["device_ms"].items()
               if name.endswith("pass_kernel")]
    rec["pass_share_of_bound"] = (rec["bound_ms"] / pass_ms[0]
                                  if pass_ms else None)
    return rec


#: K10's design, as the k10_time lines name it (csrc/highest_inverse.cu).
K10_DESIGN = ("compaction; a stable sort of the indices by slot; M, f32 "
              "sums over each slot's indices; G, D_S at the listed rows; "
              "3xTF32 wgmma.m64n64k8 over each image's slots on 64 x 192 "
              "tiles walked persistently, one TMA producer thread, each "
              "k-step's f32 add overlapped; the u8 epilogue with K7's "
              "rounding without conversion instructions, four pixels a "
              "unit: where rows lie on 16 bytes each warpgroup's pixels "
              "fetched by a second producer thread's TMA box during the "
              "products and stored by TMA (a ring of three stages), "
              "otherwise a thread's words all loaded before any is rounded")
#: K10's device launches a call: compaction, sort, M, G, the pass.
K10_DEVICE_LAUNCHES = 5


def phase_k10() -> dict:
    """K10 (HIGHEST's sparse inverse) through ``highest_inverse.gates`` and
    an f64 error no larger than the plain route's, both modes bit-identical
    on a second call: at 48 x 1080p and 8 x 4K, in landscape and portrait,
    on 1/f textures and on the harness's random u8, at the base's n = 1000
    ranked indices with the updates of n = 1000 marks; at 444 x 640, 640 x
    444 and 37 x 59 at n = 1, 1000 and 20,000 (random indices with
    repeats; the f64 comparison with the plain route is not required
    there); then its time (``_k10_timing``) at 48 x 1080p and 8 x 4K on
    both contents: the record of ``highest_inverse``, from the 48 x 1080p
    random u8, the harness's rate inputs."""
    import torch

    worst, times = 0.0, {}
    for content in ("textures", "random_u8"):
        for b, h, w in ((48, 1080, 1920), (48, 1920, 1080),
                        (8, 2160, 3840), (8, 3840, 2160)):
            # K9's seeds: the same textures, made once (_texture_batch).
            rgb, delta, idx = k10_inputs(content, 90 + b + (h > w), b, h, w)
            worst = max(worst, _compare_k10(content, rgb, delta, idx, True))
            if h <= w:
                rec = _k10_timing(rgb, delta, idx)
                times[content, b] = rec
                log("k10_time", content=content, shape=[b, h, w], n=N,
                    card=_card(), design=K10_DESIGN, **rec)
                if rec["device_launches_per_call"] > K10_DEVICE_LAUNCHES:
                    raise AssertionError(
                        f"K10 makes more than {K10_DEVICE_LAUNCHES} device "
                        "launches")
            del rgb, delta, idx
            torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(105)
    for h, w in ((444, 640), (640, 444), (37, 59)):
        rgb = textures(97 + h, 2, h, w)
        for n in (1, 1000, 20000):
            idx = torch.randint(0, h * w, (2, n), generator=gen,
                                device="cuda")
            delta = torch.randn((2, n), generator=gen, device="cuda") * 20.0
            worst = max(worst, _compare_k10("random_idx", rgb, delta, idx,
                                            False))
    rec = times["random_u8", 48]
    return {"max_abs_err": worst, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "library_ms": rec["library_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"]}


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
    extraction, so that chained calls cannot overlap (the harness's step,
    ``bench.run_verified_bench``)."""
    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import bench

    marked, ext = wm.embed_verified(x, marks, cfg)
    return bench._flip(marked, ext)


def _harness_rate(batch: int, size: str, precision, iters: int,
                  rank_version: int = 2) -> dict:
    """images/s of ``embed_verified`` from the port's bench harness: the
    median of its three timed chains of ``iters`` calls, every run's rate
    and the iters. Rank generation 2 runs ``bench.run_verified_bench``
    itself; generation 1, which the harness's configs do not name, its
    ``_timed_chain`` on the same inputs and step."""
    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import bench

    if rank_version == 2:
        res = bench.run_verified_bench(batch=batch, size=size, iters=iters,
                                       precision=precision.value)
        secs, runs = res["ms_per_image"] * batch / 1e3, res["seconds_runs"]
    else:
        h, w = bench.parse_size(size)
        cfg = wm.WriteConfig(precision=precision, rank_version=rank_version)
        rgb, marks = bench._inputs(np.random.default_rng(0), batch, h, w, N,
                                   torch.device("cuda"))
        secs, runs = bench._timed_chain(
            lambda x: _chained_step(x, marks, cfg), rgb, iters, "cuda")
    return {"images_per_sec_median": batch / secs,
            "runs": [batch / r for r in runs], "iters": iters,
            "timer": "bench._timed_chain, CUDA events, median of 3 chains"}


def _device_profile(rgb, marks, cfg, calls: int = 3) -> dict:
    """torch.profiler over ``calls`` chained calls after a warm-up: the
    window on the host clock, the device's kernel time in it, the idle share
    and the five kernels that take the most time, each as [name, ms,
    launches recorded] (a kernel the profiler failed to record shows as a
    launch short of ``calls``). The pipeline's ``ssw.*`` ranges also show
    on the device's timeline: they are not kernels, so they are kept apart,
    as the device-side span of each stage summed over the calls."""
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
    spans: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if getattr(e, "is_user_annotation", False) or e.name.startswith("ssw."):
            spans[e.name] = spans.get(e.name, 0.0) + ms
            continue
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += ms
        rec[1] += 1
    kernel_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"calls": calls, "window_ms": window_ms, "kernel_ms": kernel_ms,
            "idle_share": (1.0 - kernel_ms / window_ms) if by_name else None,
            "stage_spans_ms": spans,
            "top_kernels_ms": [[name.replace("(anonymous namespace)::", "")[:72],
                                ms, n] for name, (ms, n) in top]}


def _stage_timer(stages: dict):
    """``run(name, fn)``: calls ``fn``, appends its ms to ``stages[name]``
    (CUDA events around it, then a sync) and returns its result."""
    import torch

    def run(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        stages.setdefault(name, []).append(start.elapsed_time(end))
        return out
    return run


def _median_stages(stages: dict) -> dict:
    """Each stage's median ms over the rounds after the first (a warm-up):
    one round's host hiccup does not make a stage's number."""
    return {k: float(np.median(v[1:])) for k, v in stages.items()}


def _stage_breakdown(rgb, marks, cfg) -> dict:
    """ms per stage of one fast-tier embed_verified call, CUDA events
    around each, the median of ``STAGE_ROUNDS`` rounds, and their sum. The
    read tail runs at DEFAULT at both fast tiers: K5
    (``k5_read_tail``); beside it, on the same inputs and not in the sum,
    the route it replaced, K1's pair mode and the plain gather-dot
    (``old_read_tail_ms``)."""
    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.kernels.embed_epilogue import (
        embed_epilogue)
    from spread_spectrum_watermarking_torch.kernels.luma_pass import luma_pass
    from spread_spectrum_watermarking_torch.kernels.read_tail import read_tail
    from spread_spectrum_watermarking_torch.models import pipeline as tp
    from spread_spectrum_watermarking_torch.ops import dct, modulation, ranking

    h, w = rgb.shape[1:3]
    ax = dct.shorter_axis(h, w)
    stages, old = {}, {}
    box = {}
    run, run_old = _stage_timer(stages), _stage_timer(old)

    first = "k1_high_first_pass" if cfg.precision is Precision.HIGH \
        else "k1_first_pass"
    for _ in range(STAGE_ROUNDS + 1):  # the first round warms up
        box["t"] = run(first, lambda: luma_pass(rgb, None, cfg.precision))
        box["plane"] = run("second_pass", lambda: tp._second_pass(box["t"], ax))
        box["iv"] = run("select", lambda: ranking.approx_top_indices(
            box["plane"], N, cfg.ordering, version=cfg.rank_version))
        idx, vals = box["iv"]
        box["delta"] = run("modulate", lambda: modulation.embed_marks(
            vals, marks[None].expand(rgb.shape[0], *marks.shape),
            cfg.insertion.method, cfg.insertion.alpha) - vals)
        box["marked"] = run("k4_epilogue", lambda: embed_epilogue(
            rgb, box["delta"], idx))
        run("k5_read_tail", lambda: read_tail(box["marked"], rgb, idx))
        box["td"] = run_old("k1_pair_pass",
                            lambda: luma_pass(box["marked"], rgb))
        run_old("read_dot_at", lambda: dct.dct2_dot_at(
            box["td"], idx, contracted_axis=ax, precision=Precision.DEFAULT))
    out = _median_stages(stages)
    return {**out, "sum_ms": sum(out.values()),
            "old_read_tail_ms": _median_stages(old)}


def _kernel_counts() -> dict:
    from spread_spectrum_watermarking_torch import kernels

    return kernels.launch_counts()


def _zero_kernel_counts() -> None:
    from spread_spectrum_watermarking_torch import kernels

    kernels.reset_launch_counts()


@contextlib.contextmanager
def _sparse_products():
    """Counts, while the block runs, the calls of
    ``ops.dct.sparse_factors_f32``, which makes the factors of the f32
    cuBLAS sparse product (the route K10 replaced on HIGHEST paths): a
    list with one entry a call."""
    from spread_spectrum_watermarking_torch.ops import dct

    calls, real = [], dct.sparse_factors_f32
    dct.sparse_factors_f32 = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        yield calls
    finally:
        dct.sparse_factors_f32 = real


def phase_fast_path(precision, recs: dict | None, rank_version: int = 2,
                    iters: int = 64) -> None:
    """One fast tier's path at 1080p batch 48 and rank generation
    ``rank_version``: ``embed_verified`` with the launch counts of that one
    call (DEFAULT: K1, K5 and K4; HIGH: K1's high mode, K5 and K4;
    never K6; K3 over the plane, its re-sort inside, at generation 2, twice
    over keys at generation 1), then the checks, the stages, the rate (the
    harness's chains of ``iters`` calls) and the profile. ``recs``: the
    kernel records to fill with this path's launches (generation 2: K1, K4
    and K3's plane mode; generation 1: K3's key mode), or None."""
    import torch

    import spread_spectrum_watermarking_torch as wm

    high = precision is wm.Precision.HIGH
    pre = "gen1_" if rank_version == 1 else ""
    tag = pre + ("high_" if high else "")
    cfg = wm.WriteConfig(precision=precision, rank_version=rank_version)
    rcfg = wm.ReadConfig(precision=precision, rank_version=rank_version)
    gen = torch.Generator(device="cuda").manual_seed(8 if high else 3)
    rgb = textures(80 if high else 30, 48, 1080, 1920)
    marks = torch.randn((48, 1, N), generator=gen, device="cuda")
    torch.cuda.synchronize()

    _zero_kernel_counts()
    marked, ext = wm.embed_verified(rgb, marks, cfg)
    torch.cuda.synchronize()
    counts = _kernel_counts()
    # The read tail is one K5 call, never K1's pair mode.
    read = counts["k5"] == 1 and counts["k1_pair"] == 0
    if high:
        ran = counts["k1_high"] > 0 and read and counts["k4"] > 0
    else:
        ran = (counts["k1"] > 0 and read and counts["k4"] > 0
               and counts["k1_high"] == 0)
    if recs is not None and rank_version == 1:
        recs["topk_select"]["launches"] = counts["k3"]
    elif recs is not None and high:
        recs["luma_pass_high"]["launches"] = counts["k1_high"]
    elif recs is not None:
        recs["luma_pass"]["launches"] = counts["k1"] - counts["k1_pair"]
        recs["read_tail"]["launches"] = counts["k5"]
        recs["embed_epilogue"]["launches"] = counts["k4"]
        recs["topk_select_plane"]["launches"] = counts["k3_plane"]
    # K3: generation 2 is one call over the plane, its re-sort inside;
    # generation 1 selects over its keys, then re-sorts.
    if rank_version == 2:
        ran = ran and counts["k3_plane"] >= 1 and counts["k3"] == 0
    else:
        ran = ran and counts["k3"] >= 2
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
    log(pre + ("high_path" if high else "main_path"), shape=[48, 1080, 1920],
        n=N, rank_version=rank_version, launches=counts, detect_bit_equal=True,
        share_pixels_changed=float((marked != rgb).float().mean()), **det)
    if not high and rank_version == 2:
        _pair_path(rgb, marked, ext, marks, rcfg, gen, recs)

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
    torch.cuda.empty_cache()
    rate = _harness_rate(48, "1080p", precision, iters, rank_version)
    rand = torch.randint(0, 256, (48, 1080, 1920, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    log(pre + ("high_rate" if high else "main_path_rate"),
        shape=[48, 1080, 1920], n=N, **rate)
    log(f"{tag}profile", shape=[48, 1080, 1920], n=N,
        **_device_profile(rand, marks, cfg))


def _pair_path(rgb, marked, ext, marks, rcfg, gen, recs) -> None:
    """K1's pair mode on its own path, ``extract(sparse_derived=False)``
    (the full first pass, then the full second pass): launched once there
    and K5 not, within 0.1 sigma of the main path's read and above 6
    sigma. ``recs``: K1 pair's record takes this call's launches."""
    import torch

    import spread_spectrum_watermarking_torch as wm

    _zero_kernel_counts()
    full = wm.extract(rgb, marked, N, rcfg, sparse_derived=False)
    torch.cuda.synchronize()
    counts = _kernel_counts()
    if counts["k1_pair"] != 1 or counts["k5"] != 0:
        raise AssertionError(f"extract(sparse_derived=False) launched {counts}")
    if recs is not None:
        recs["luma_pass_pair"]["launches"] = counts["k1_pair"]
    det = _check_detection("extract(sparse_derived=False)", full, marks, gen)
    sims = [torch.diagonal(wm.similarity(e, marks[:, 0])) for e in (ext, full)]
    gap = float((sims[0] - sims[1]).abs().max())
    log("pair_path", shape=list(rgb.shape[:3]), n=N, launches=counts,
        max_sim_gap_sigma=gap, **det)
    if not gap <= 0.1:
        raise AssertionError(f"the full read is {gap} sigma from K5's")


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


def phase_custom() -> None:
    """The custom callables on 4 x 1080p at each tier, each reimplementing
    a built-in and held to it, with the launch counts of each call: the
    fast tiers' embed runs K1 and K4 (K1's high mode at HIGH) and their
    read K1 and K5; HIGHEST's embed K6a and K10 once, K7 and the f32
    cuBLAS sparse product never, its read K6a; every call K3."""
    import torch

    import spread_spectrum_watermarking_torch as wm

    alpha = 0.1
    option2 = lambda i, o, w: o * (1.0 + alpha * w)  # noqa: E731
    inverse = lambda i, b, d: (d - b) / (b * alpha)  # noqa: E731
    energy = lambda i, v: v * v  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(13)
    rgb = textures(95, 4, 1080, 1920)
    marks = torch.randn((4, 1, N), generator=gen, device="cuda")

    def counted(fn):
        _zero_kernel_counts()
        with _sparse_products() as products:
            out = fn()
            torch.cuda.synchronize()
        return out, {**_kernel_counts(), "sparse_products": len(products)}

    def launched(counts, fast: bool, write: bool, high: bool) -> bool:
        if counts["k3"] + counts["k3_plane"] + counts["k3_coeffs"] < 1:
            return False
        if not fast:
            return counts["k6a"] > 0 and counts["sparse_products"] == 0 and (
                (counts["k10"] == 1 and counts["k7"] == 0) or not write)
        first = (counts["k1_high"] if high
                 else counts["k1"] - counts["k1_pair"])
        return first > 0 and (counts["k4"] > 0 if write
                              else counts["k5"] > 0)

    for p in (wm.Precision.DEFAULT, wm.Precision.HIGH, wm.Precision.HIGHEST):
        fast, high = p is not wm.Precision.HIGHEST, p is wm.Precision.HIGH
        rcfg = wm.ReadConfig(precision=p)
        builtin = wm.embed(rgb, marks, wm.WriteConfig(precision=p))
        custom, c_ins = counted(lambda: wm.embed(rgb, marks, wm.WriteConfig(
            precision=p, custom_insert=option2)))
        if not torch.equal(custom, builtin):
            raise AssertionError(f"custom Option2 at {p.value}: not bit-equal "
                                 "to the built-in")
        ext = wm.extract(rgb, builtin, N, rcfg)
        ext_c, c_ext = counted(lambda: wm.extract(rgb, builtin, N, wm.ReadConfig(
            precision=p, custom_extract=inverse)))
        own = [torch.diagonal(wm.similarity(e, marks[:, 0])) for e in (ext, ext_c)]
        gap = float((own[0] - own[1]).abs().max())
        det = _check_detection(f"custom extract {p.value}", ext_c, marks, gen)
        if not gap <= 1e-3:
            raise AssertionError(f"custom extract at {p.value}: {gap} sigma "
                                 "from the built-in")
        if fast:
            a = wm.rank_base(rgb, N, rcfg)[0]
            b = wm.rank_base(rgb, N, wm.ReadConfig(precision=p,
                                                   custom_ordering=energy))[0]
        else:
            a = wm.prepare_base(rgb, N, rcfg)[1]
            b = wm.prepare_base(rgb, N, wm.ReadConfig(custom_ordering=energy))[1]
        share = min(len(set(x.tolist()) & set(y.tolist())) / N
                    for x, y in zip(a.cpu(), b.cpu()))
        if share < (0.95 if fast else 1.0) or (not fast and not torch.equal(a, b)):
            raise AssertionError(f"custom ENERGY ordering at {p.value}: "
                                 f"{share} of the indices in common")
        (_, ext_o), c_ord = counted(lambda: wm.embed_verified(
            rgb, marks, wm.WriteConfig(precision=p, custom_ordering=energy)))
        det_o = _check_detection(f"custom ordering {p.value}", ext_o, marks, gen)
        if not (launched(c_ins, fast, True, high)
                and launched(c_ext, fast, False, high)
                and launched(c_ord, fast, True, high)):
            raise AssertionError(f"custom callables at {p.value} launched "
                                 f"{c_ins}, {c_ext}, {c_ord}")
        log("custom", shape=[4, 1080, 1920], n=N, tier=p.value,
            insert_bit_equal=True, extract_max_gap_sigma=gap,
            extract_min_self_sigma=det["min_self_sigma"],
            ordering_min_share_common=share,
            ordering_indices_equal=bool(torch.equal(a, b)),
            ordering_min_self_sigma=det_o["min_self_sigma"],
            launches_insert=c_ins, launches_extract=c_ext,
            launches_ordering=c_ord)


def phase_bench() -> None:
    """The bench harness's configs, each once at its JAX defaults on the
    card, each result on its own line with the wall seconds it took; the
    corpus must detect every image's own mark as its top match, above
    6 sigma."""
    from spread_spectrum_watermarking_torch import bench

    runs = [("bench_throughput", lambda: bench.run_bench(quiet=True)),
            ("bench_latency", bench.run_latency_bench),
            ("bench_cached_extract", bench.run_cached_extract_bench)]
    runs += [(f"bench_sweep_{p}", lambda p=p: bench.run_similarity_sweep_bench(
        precision=p)) for p in ("highest", "high", "default")]
    runs.append(("bench_corpus", bench.run_corpus_bench))
    for name, fn in runs:
        t0 = time.perf_counter()
        res = fn()
        log(name, wall_seconds=time.perf_counter() - t0, **res)
        rates = [v for k, v in res.items() if k.endswith("_per_sec")]
        if not rates or not all(np.isfinite(r) and r > 0 for r in rates):
            raise AssertionError(f"{name}: rates {rates}")
    if not (res["detection_rate_top1"] == 1.0
            and res["min_own_mark_sigma"] > SIGMA):
        raise AssertionError(f"the corpus bench missed marks: {res}")


def _k10_stage(run, rgb, delta, idx):
    """HIGHEST's sparse inverse as one stage: K10 in its u8 mode."""
    from spread_spectrum_watermarking_torch.kernels.highest_inverse import (
        highest_inverse)

    return run("k10_inverse", lambda: highest_inverse(rgb, delta, idx))


def _product_k7_stages(run, rgb, delta, idx):
    """HIGHEST's sparse inverse as a checkout without K10 runs it: the dY
    plane of ``pipeline._sparse_idct_delta`` (the f32 cuBLAS product
    there), then K7's u8 mode."""
    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.kernels.add_quantize import (
        add_quantize)
    from spread_spectrum_watermarking_torch.models import pipeline as tp

    h, w = rgb.shape[1:3]
    dy = run("sparse_delta", lambda: tp._sparse_idct_delta(
        delta, idx, h, w, Precision.HIGHEST))
    return run("k7_add_quantize", lambda: add_quantize(rgb, dy, True))


def _stage_breakdown_highest(rgb, marks, cfg, read=None,
                             inverse=_k10_stage) -> dict:
    """ms per stage of one HIGHEST embed_verified call (its sparse embed,
    with ``inverse(run, rgb, delta, idx)`` timing its inverse's stages, by
    default K10's; then its read: K8's two lumas, K9's read, or ``read(y,
    idx)`` in its place), CUDA events around each, the median of
    ``STAGE_ROUNDS`` rounds, and their sum."""
    import torch

    from spread_spectrum_watermarking_torch.ops import (colorspace, dct,
                                                        modulation, ranking)

    if read is None:
        from spread_spectrum_watermarking_torch.kernels.highest_read import (
            highest_read as read)
    b, h, w = rgb.shape[:3]
    stages = {}
    box = {}
    run = _stage_timer(stages)
    ie = cfg.insertion
    for _ in range(STAGE_ROUNDS + 1):  # the first round warms up
        y = run("k8_luma", lambda: colorspace.luma(rgb))
        box["c"] = run("k6a_forward", lambda: dct.dct2_2d(y))
        box["idx"] = run("select", lambda: ranking.top_indices(
            box["c"], N, cfg.ordering))
        idx = box["idx"]
        box["orig"] = run("gather", lambda: torch.gather(
            box["c"].reshape(b, h * w), -1, idx))
        box["new"] = run("modulate", lambda: modulation.embed_marks(
            box["orig"], marks[None].expand(b, *marks.shape), ie.method,
            ie.alpha))
        box["m"] = inverse(run, rgb, box["new"] - box["orig"], idx)
        yd = run("k8_derived_luma", lambda: colorspace.luma(box["m"]))
        run("k9_read", lambda: read(yd, idx))
    out = _median_stages(stages)
    out["sum"] = sum(out.values())
    return out


def phase_highest(k6a_rec: dict, k6b_rec: dict, k7_rec: dict,
                  k3c_rec: dict, k8_rec: dict, k9_rec: dict,
                  k10_rec: dict) -> None:
    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import bench
    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
    from spread_spectrum_watermarking_torch.kernels import luma_u8 as k8
    from spread_spectrum_watermarking_torch.models import pipeline as tp
    from spread_spectrum_watermarking_torch.ops import dct

    cfg, rcfg = wm.WriteConfig(), wm.ReadConfig()  # HIGHEST, the default
    gen = torch.Generator(device="cuda").manual_seed(6)
    rgb = textures(60, 48, 1080, 1920)
    marks = torch.randn((48, 1, N), generator=gen, device="cuda")
    torch.cuda.synchronize()

    # The call counts its kernels, any call of the plain read
    # (dct.dct2_coeffs_at: the f32 cuBLAS pass over the whole plane) and
    # any of the f32 cuBLAS sparse product (_sparse_products).
    plain_reads, out = [], {}
    coeffs_at = dct.dct2_coeffs_at
    dct.dct2_coeffs_at = lambda *a, **k: plain_reads.append(1) or coeffs_at(
        *a, **k)
    try:
        _zero_kernel_counts()
        with _sparse_products() as products:
            call_mb = peak_mb(lambda: out.update(
                zip(("marked", "ext"), wm.embed_verified(rgb, marks, cfg))))
        counts = _kernel_counts()
    finally:
        dct.dct2_coeffs_at = coeffs_at
    marked, ext = out["marked"], out["ext"]
    k6a_rec["launches"] = counts["k6a"]
    k7_rec["launches"] = counts["k7"]
    k3c_rec["launches"] = counts["k3_coeffs"]
    k8_rec["launches"] = counts["k8"]
    k9_rec["launches"] = counts["k9"]
    k10_rec["launches"] = counts["k10"]
    if (counts["k6a"] != 1 or counts["k10"] != 1 or counts["k7"] != 0
            or counts["k3_coeffs"] == 0 or counts["k3"] != 0
            or counts["k8"] != 2 or counts["k9"] != 1 or plain_reads
            or products):
        raise AssertionError(f"the HIGHEST path launched {counts}, "
                             f"{len(plain_reads)} plain reads, "
                             f"{len(products)} f32 sparse products")
    det = _check_detection("1080p HIGHEST", ext, marks, gen)
    # The plain route's read (the table's lumas, dct2_coeffs_at) of the
    # same marked images at the same indices: the sigmas within 0.01.
    flat, idx = wm.prepare_base(rgb, N, rcfg)
    plain_ext = tp._extract_values(
        rcfg, idx, torch.gather(flat, -1, idx),
        dct.dct2_coeffs_at(k8.luma_u8_reference(marked), idx))
    del flat
    plain_gap = float((torch.diagonal(wm.similarity(plain_ext, marks[:, 0]))
                       - torch.diagonal(wm.similarity(ext, marks[:, 0])))
                      .abs().max())
    if not plain_gap <= 0.01:
        raise AssertionError(f"K9's read is {plain_gap} sigma off the plain "
                             "route's")
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
        plain_reads=len(plain_reads), sparse_products=len(products),
        peak_mb=call_mb,
        plain_route_max_gap_sigma=plain_gap,
        extract_bit_equal=True, prepared_max_gap_sigma=gap,
        share_pixels_changed=float((marked != rgb).float().mean()), **det)

    # embed alone: the same marked images, K10 once, K7 and the f32 sparse
    # product never.
    _zero_kernel_counts()
    with _sparse_products() as products:
        alone = wm.embed(rgb, marks, cfg)
        torch.cuda.synchronize()
    counts = _kernel_counts()
    log("highest_embed", shape=[48, 1080, 1920], n=N, launches=counts,
        sparse_products=len(products),
        bit_equal_to_embed_verified=bool(torch.equal(alone, marked)))
    if (counts["k10"] != 1 or counts["k7"] != 0 or products
            or not torch.equal(alone, marked)):
        raise AssertionError(f"HIGHEST embed launched {counts}, "
                             f"{len(products)} f32 sparse products")
    del alone

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
    _zero_kernel_counts()
    with _sparse_products() as products:
        out = wm.Writer(img, device="cuda").mark(mark)
    counts = _kernel_counts()
    if counts["k10"] != 1 or counts["k7"] != 0 or products:
        raise AssertionError(f"Writer.mark launched {counts}, "
                             f"{len(products)} f32 sparse products")
    got = wm.Reader.base(img, device="cuda").extract(
        wm.Reader.derived(out, device="cuda"), N)
    sim = wm.Tester(got, device="cuda").similarity(mark)
    step = int(np.abs(out.astype(int) - marked[0].cpu().numpy()).max())
    if not (sim.exceeds_sigma(SIGMA) and step <= 1):
        raise AssertionError("Writer/Reader/Tester on the card disagree")
    log("highest_api", shape=list(img.shape), n=N, similarity=sim.similarity,
        max_u8_step_from_batch=step, mark_launches=counts)

    log("highest_stages_ms", shape=[48, 1080, 1920], n=N,
        **_stage_breakdown_highest(rgb, marks[0], cfg))
    # The call on the textures, chained as the harness chains it.
    secs, runs = bench._timed_chain(
        lambda x: _chained_step(x, marks, cfg), rgb.clone(), 16, "cuda")
    log("highest_textures_rate", shape=[48, 1080, 1920], n=N,
        images_per_sec_median=48 / secs, runs=[48 / r for r in runs],
        iters=16, timer="bench._timed_chain, CUDA events, median of 3 "
        "chains")
    del marked, ext, rgb
    torch.cuda.empty_cache()
    rate = _harness_rate(48, "1080p", cfg.precision, 16)
    rand = torch.randint(0, 256, (48, 1080, 1920, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    log("highest_rate", shape=[48, 1080, 1920], n=N, **rate)
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
        del marked, ext
        rate = _harness_rate(8, "4k", p, 32)
        log("4k" if p is wm.Precision.DEFAULT else "4k_high",
            shape=[8, 2160, 3840], n=N, launches=counts, **det, **rate)


def _cli(argv: list) -> tuple[int, str]:
    """``cli.main(argv)`` in this process: its exit code and its stdout."""
    import contextlib
    import io

    from spread_spectrum_watermarking_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    return rc, out.getvalue()


def _jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _cli_detect(tmp, tier: str, outs, src) -> None:
    """``detect`` on base t00 at ``tier``: 50 derived paths in chunks of 32,
    then again in chunks of one, which must give the same records."""
    import torch
    from PIL import Image

    from spread_spectrum_watermarking_torch import cli

    own = outs / "t00_wm.png"
    q90 = tmp / f"t00_{tier}_q90.jpg"
    Image.open(own).save(q90, quality=90)
    derived = [own, q90, src / "t00.jpg"] + sorted(
        p for p in outs.glob("*_wm.png") if p != own)
    runs = {}
    for chunk in (cli.DETECT_CHUNK, 1):
        saved, cli.DETECT_CHUNK = cli.DETECT_CHUNK, chunk
        jl = tmp / f"detect_{tier}_{chunk}.jsonl"
        try:
            _zero_kernel_counts()
            t0 = time.perf_counter()
            rc, _ = _cli(["detect", src / "t00.jpg", outs / "t00_wm.json",
                          "--derived", *derived, "--jsonl", jl])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            cli.DETECT_CHUNK = saved
        runs[chunk] = (rc, _jsonl(jl), wall, _kernel_counts())
    rc, rows, wall, counts = runs[cli.DETECT_CHUNK]
    sims = [r.get("similarity") for r in rows]
    if rc != 0 or len(rows) != len(derived) or None in sims:
        raise AssertionError(f"detect at {tier}: rc {rc}, {len(rows)} rows")
    if not (sims[0] > SIGMA and sims[1] > SIGMA and sims[2] == 0.0
            and max(sims[3:]) < SIGMA):
        raise AssertionError(f"detect at {tier} misread: {sims[:3]}, "
                             f"others up to {max(sims[3:])}")
    single = runs[1][1]
    gap = max(abs(a["similarity"] - b["similarity"])
              for a, b in zip(rows, single))
    same = [{k: v for k, v in r.items() if k != "similarity"} for r in rows]
    if same != [{k: v for k, v in r.items() if k != "similarity"}
                for r in single] or not gap <= 1e-5:
        raise AssertionError(f"detect at {tier}: chunks of one differ "
                             f"(similarity gap {gap})")
    fast = counts["k1"] > 0 and counts["k6a"] == 0
    if not (counts["k6a"] > 0 if tier == "highest" else fast):
        raise AssertionError(f"detect at {tier} launched {counts}")
    log(f"cli_detect_{tier}", card=_card(), derived=len(derived),
        chunk=cli.DETECT_CHUNK, launches=counts, own_sigma=sims[0],
        q90_sigma=sims[1], base_sigma=sims[2],
        max_other_sigma=max(sims[3:]), chunks_of_one_max_gap_sigma=gap,
        wall_seconds=wall, images_per_sec=len(derived) / wall,
        chunks_of_one_wall_seconds=runs[1][2],
        chunks_of_one_images_per_sec=len(derived) / runs[1][2])


def _cli_breakdown(src, outs) -> dict:
    """Where the CLI's wall time goes at 1080p: each host and device piece
    of ``batch`` (48 JPEGs decoded, copied in, embedded, copied out, PNGs
    encoded on threads) and of ``detect`` (48 PNGs decoded, one Reader
    read of all 48 against the cached base, its copies in and out
    included) timed alone on the same files, host clock around a CUDA
    sync, the device pieces after a warm-up call."""
    import pathlib
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch.utils import image_io

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    secs = {}
    jpegs = sorted(src.glob("*.jpg"))
    imgs, secs["decode_jpeg"] = timed(lambda: image_io.load_batch_u8(jpegs))
    host = np.stack(imgs)
    rgb, secs["copy_in"] = timed(lambda: torch.from_numpy(host).cuda())
    marks = torch.randn((len(imgs), 1, N),
                        generator=torch.Generator().manual_seed(9)).cuda()
    pngs = sorted(outs["highest"].glob("*_wm.png"))
    dimgs, secs["decode_png"] = timed(lambda: image_io.load_batch_u8(pngs))
    dstack = np.stack(dimgs)
    for tier in ("highest", "default"):
        prec = wm.Precision(tier)
        cfg, rcfg = wm.WriteConfig(precision=prec), wm.ReadConfig(
            precision=prec)
        wm.embed(rgb, marks, cfg)
        marked, secs[f"embed_{tier}"] = timed(lambda: wm.embed(rgb, marks,
                                                               cfg))
        reader = wm.Reader.base(imgs[0], rcfg)
        reader._extract_stack(dstack, N)  # ranks the base, warms up
        _, secs[f"read_chunk_{tier}"] = timed(
            lambda: reader._extract_stack(dstack, N))
    back, secs["copy_out"] = timed(lambda: marked.cpu().numpy())
    with tempfile.TemporaryDirectory() as d:
        paths = [pathlib.Path(d) / f"{i:02d}.png" for i in range(len(back))]
        with ThreadPoolExecutor(max_workers=8) as ex:
            _, secs["encode_png"] = timed(
                lambda: list(ex.map(image_io.save_rgb, paths, back)))
    return {"images": len(imgs), "seconds": secs}


def phase_cli() -> None:
    """Phase 11: the command line at 1080p (see the module's docstring)."""
    import pathlib
    import tempfile

    import torch
    from PIL import Image

    from spread_spectrum_watermarking_torch.utils import (_codec, _native,
                                                          rng_compat)

    # The native builds, at their first use.
    plain_rng = rng_compat.ChaChaRng.seed_from_u64(1)
    plain = np.asarray([rng_compat.standard_normal_f64(plain_rng)
                        for _ in range(N)], dtype=np.float32)
    native = _native.available()
    rng_equal = bool(native and np.array_equal(
        _native.generate_fixed_normal_sequence(1, N), plain))
    if native and not rng_equal:
        raise AssertionError("the native RNG differs from its plain version")
    _codec.available()
    log("native", rng=dict(_native.BUILD_INFO), rng_bit_equal_seed1_n1000=(
        rng_equal if native else "not built"), codec=dict(_codec.BUILD_INFO),
        decoder="native codec" if _codec.available() else
        f"PIL ({_codec.BUILD_INFO.get('missing')} absent)")

    imgs = _texture_batch(60, 48, 1080, 1920)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        src = tmp / "in"
        src.mkdir()
        for i, img in enumerate(imgs):
            Image.fromarray(img).save(src / f"t{i:02d}.jpg", quality=95)
        outs = {}
        for tier in ("highest", "default"):
            outs[tier] = d = tmp / tier
            _zero_kernel_counts()
            t0 = time.perf_counter()
            with _sparse_products() as products:
                rc, said = _cli(["batch", src, "--output-dir", d, "--seed",
                                 9, "--jsonl", tmp / f"batch_{tier}.jsonl",
                                 "--precision", tier])
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _kernel_counts()
            pairs = (len(list(d.glob("*_wm.png"))),
                     len(list(d.glob("*_wm.json"))))
            if rc != 0 or pairs != (48, 48):
                raise AssertionError(f"batch at {tier}: rc {rc}, {pairs}")
            launched = (counts["k6a"] > 0 and counts["k10"] == 1
                        and counts["k7"] == 0 and not products
                        if tier == "highest" else
                        counts["k1"] > 0 and counts["k4"] > 0)
            if not launched:
                raise AssertionError(f"batch at {tier} launched {counts}")
            log(f"cli_batch_{tier}", card=_card(), images=48,
                shape=[1080, 1920, 3], launches=counts,
                wall_seconds=wall, images_per_sec=48 / wall,
                said=said.strip())

            # `test`: each output's own mark matches, its neighbour's not.
            sims = []
            for i in range(4):
                jl = tmp / f"test_{tier}_{i}.jsonl"
                rc, _ = _cli(["test", src / f"t{i:02d}.jpg",
                              d / f"t{i:02d}_wm.png", d / f"t{i:02d}_wm.json",
                              d / f"t{i + 1:02d}_wm.json", "--jsonl", jl])
                own, foreign = _jsonl(jl)
                if rc != 0 or not own["matches"] or foreign["matches"]:
                    raise AssertionError(f"test at {tier}: {own}, {foreign}")
                sims.append([own["similarity"], foreign["similarity"]])
            log(f"cli_test_{tier}", own_and_foreign_sigma=sims)

            _cli_detect(tmp, tier, d, src)

        log("cli_breakdown", card=_card(), **_cli_breakdown(src, outs))

        # The module entry point, as a user runs it.
        one = tmp / "one"
        one.mkdir()
        Image.fromarray(imgs[0]).save(one / "x.jpg", quality=95)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "spread_spectrum_watermarking_torch.cli",
             "watermark", str(one / "x.jpg"), "-p", "--seed", "3"],
            cwd=pathlib.Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0 or "exceeds 6 sigma: true" not in proc.stdout:
            raise AssertionError(f"cli subprocess: {proc.returncode}\n"
                                 f"{proc.stdout}\n{proc.stderr[-2000:]}")
        log("cli_subprocess", seconds=time.perf_counter() - t0,
            said=proc.stdout.strip().splitlines())


def _step_share(a, b) -> tuple[int, float]:
    """(largest u8 step, share of values that differ) between two images."""
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def _own_cross(ext, marks) -> tuple[float, float]:
    """(smallest own-mark sigma, largest |cross-mark| sigma) of (B, n)
    extractions against their (B, n) marks."""
    import torch

    from spread_spectrum_watermarking_torch.ops import modulation

    sims = modulation.similarity(torch.as_tensor(ext, device="cuda"),
                                 torch.as_tensor(marks, device="cuda")).cpu()
    eye = torch.eye(sims.shape[0], dtype=torch.bool)
    cross = float(sims[~eye].abs().max()) if sims.shape[0] > 1 else 0.0
    return float(torch.diagonal(sims).min()), cross


def _need_launches(tag: str, counts: dict, names) -> None:
    missing = [k for k in names if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels {missing} not launched: {counts}")


def _need_no_launches(tag: str, counts: dict, names) -> None:
    found = [k for k in names if counts.get(k, 0) != 0]
    if found:
        raise AssertionError(f"{tag}: kernels {found} launched: {counts}")


def _corpus_breakdown(mesh) -> dict:
    """One chunk of the corpus-sharded bench (8 4K images, its inputs,
    HIGHEST) timed by parts with CUDA events, ms: the host-to-device copy
    of the chunk, ``embed_corpus`` on the device-resident chunk, the copy
    of the base, ``extract_corpus``, the similarity; the mean of 3 after
    a warm-up."""
    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import bench
    from spread_spectrum_watermarking_torch.ops import modulation
    from spread_spectrum_watermarking_torch.parallel import mesh as pmesh
    from spread_spectrum_watermarking_torch.parallel import \
        pipeline_sharded as ps

    rng = np.random.default_rng(3)
    imgs = bench.natural_corpus_chunk(8, 2160, 3840, rng)
    marks = torch.from_numpy(
        rng.standard_normal((8, N)).astype(np.float32)).cuda()
    names = ("copy_chunk", "embed_corpus", "copy_base", "extract_corpus",
             "similarity")
    total = dict.fromkeys(names, 0.0)
    for rep in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        rgb = torch.from_numpy(imgs).cuda()
        ev[1].record()
        marked = ps.embed_corpus(rgb, marks, mesh)
        ev[2].record()
        base = torch.from_numpy(imgs).cuda()
        ev[3].record()
        ext = ps.extract_corpus(base, pmesh.Local(marked), N, mesh,
                                wm.ReadConfig(), height=2160)
        ev[4].record()
        modulation.similarity(ext, marks).cpu()
        ev[5].record()
        torch.cuda.synchronize()
        if rep:
            for i, k in enumerate(names):
                total[k] += ev[i].elapsed_time(ev[i + 1]) / 3
    return total


def _parallel_nccl() -> dict:
    """NCCL at the world size of the cards this script uses (one): a group
    of one rank in this process. DP embed/extract at 48 x 1080p at DEFAULT
    and HIGHEST bit-equal to the single-device call, spatial embed/extract
    of one 4K image at HIGHEST against the single-device embed, and the
    corpus-sharded bench at its defaults (BASELINE config 5)."""
    import tempfile

    import torch
    import torch.distributed as dist

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import bench
    from spread_spectrum_watermarking_torch.models import pipeline
    from spread_spectrum_watermarking_torch.parallel import mesh as pmesh
    from spread_spectrum_watermarking_torch.parallel import \
        pipeline_sharded as ps

    tmp = tempfile.mkdtemp(prefix="ssw-smoke-")
    pmesh.multihost_initialize(
        device="cuda", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
        world_size=1)
    out = {}
    try:
        mesh = pmesh.make_mesh(None, "cuda")
        rgb = _texture_batch(121, 48, 1080, 1920)
        marks = np.random.default_rng(121).standard_normal(
            (48, 1, N)).astype(np.float32)
        rgb_dev, marks_dev = torch.from_numpy(rgb).cuda(), \
            torch.from_numpy(marks).cuda()
        for p, names in ((wm.Precision.DEFAULT, ("k1", "k5", "k4",
                                                  "k3_plane")),
                         (wm.Precision.HIGHEST, ("k6a", "k10", "k3_coeffs"))):
            cfg, rcfg = wm.WriteConfig(precision=p), wm.ReadConfig(precision=p)
            _zero_kernel_counts()
            t0 = time.perf_counter()
            with _sparse_products() as products:
                marked = ps.embed_batch_sharded(rgb, marks, mesh, cfg)
                ext = ps.extract_batch_sharded(rgb, pmesh.Local(marked), N,
                                               mesh, rcfg)
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _kernel_counts()
            want = pipeline.embed(rgb_dev, marks_dev, cfg)
            want_ext = pipeline.extract(rgb_dev, want, N, rcfg)
            equal = (bool(torch.equal(marked, want)),
                     bool(torch.equal(ext, want_ext)))
            own, _ = _own_cross(ext, marks[:, 0])
            rec = dict(precision=p.value, shape=list(rgb.shape),
                       bit_equal=equal, min_own_sigma=own, launches=counts,
                       seconds_with_copies=seconds)
            log("parallel_nccl_dp", **rec)
            if not all(equal) or own <= SIGMA:
                raise AssertionError(f"NCCL DP {p.value}: {rec}")
            _need_launches(f"NCCL DP {p.value}", counts, names)
            _need_no_launches(f"NCCL DP {p.value}", counts, ("k7",))
            if products:
                raise AssertionError(f"NCCL DP {p.value}: {len(products)} "
                                     "f32 sparse products")
            out[f"dp_{p.value}"] = counts
            del marked, ext, want, want_ext
        del rgb_dev, marks_dev
        torch.cuda.empty_cache()

        img = _texture_batch(122, 1, 2160, 3840)[0]
        mark = np.random.default_rng(122).standard_normal(N).astype(
            np.float32)
        _zero_kernel_counts()
        marked = pmesh.gather(ps.embed_spatial(img, mark, mesh), mesh,
                              {0: pmesh.SPATIAL_AXIS})
        ext = ps.extract_spatial(img, marked, N, mesh)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        want = pipeline.embed(torch.from_numpy(img).cuda(),
                              torch.from_numpy(mark).cuda())
        step, share = _step_share(marked.cpu(), want.cpu())
        own, _ = _own_cross(ext[None], mark[None])
        rec = dict(shape=list(img.shape), max_step=step, share_differing=share,
                   own_sigma=own, launches=counts)
        log("parallel_nccl_spatial", **rec)
        if step > 1 or share >= 0.02 or own <= SIGMA:
            raise AssertionError(f"NCCL spatial: {rec}")
        _need_launches("NCCL spatial", counts, ("k3",))
        del marked, want
        torch.cuda.empty_cache()

        _zero_kernel_counts()
        t0 = time.perf_counter()
        res = bench.run_corpus_sharded_bench()
        counts = _kernel_counts()
        log("parallel_corpus_bench", card=_card(),
            wall_seconds=time.perf_counter() - t0, launches=counts, **res)
        if not (np.isfinite(res["corpus_images_per_sec"])
                and res["corpus_images_per_sec"] > 0
                and res["min_own_mark_sigma"] > SIGMA
                and res["max_cross_mark_sigma"] < SIGMA
                and res["comm_backend"] == "nccl"):
            raise AssertionError(f"corpus-sharded bench: {res}")
        _need_launches("corpus-sharded bench", counts, ("k7", "k3"))
        out["corpus_bench"] = counts
        log("parallel_corpus_breakdown", card=_card(),
            ms=_corpus_breakdown(mesh))
    finally:
        dist.destroy_process_group()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _parallel_ranks(backend: str = "gloo") -> dict:
    """4 spawned ranks (3 for the staged embed): gloo ranks that all compute
    on cuda:0 (NCCL refuses two ranks on one card), or with ``"nccl"``
    one rank per card of four or more. DP (4, 1), spatial (1, 4) at 1080p
    and at a size the ranks do not divide, the corpus (2, 2) at a height
    they do not divide, the staged embed, and ``dryrun_multichip(4,
    "cuda")``, each held against the single-device path on cuda:0 as the
    CPU tests hold it."""
    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch.models import pipeline
    from spread_spectrum_watermarking_torch.parallel import dryrun, launch

    rng = np.random.default_rng(123)
    dp_rgb = _texture_batch(123, 4, 1080, 1920)
    dp_marks = rng.standard_normal((4, 1, N)).astype(np.float32)
    sp = [((1, 4), _texture_batch(124, 1, 1080, 1920)[0]),
          ((1, 4), _texture_batch(125, 1, 1081, 1918)[0])]
    sp_marks = [rng.standard_normal(N).astype(np.float32) for _ in sp]
    c_imgs = _texture_batch(126, 4, 1083, 1920)
    c_marks = rng.standard_normal((4, N)).astype(np.float32)
    cases = {
        "dp": {"shape": (4, 1), "images": dp_rgb, "marks": dp_marks, "n": N,
               "precisions": ["default", "highest"]},
        "spatial": {"cases": [(shape, img, m, N)
                              for (shape, img), m in zip(sp, sp_marks)]},
        "corpus": {"shape": (2, 2), "images": c_imgs, "marks": c_marks,
                   "n": N},
    }
    t0 = time.perf_counter()
    ranks = launch.run_ranks(dryrun.parity_rank, 4, backend=backend,
                             device="cuda", timeout=300, args=(cases, "cuda"))
    seconds = time.perf_counter() - t0
    r0 = ranks[0]
    launches = [r["launches"] for r in ranks]
    out = {}

    rgb_dev = torch.from_numpy(dp_rgb).cuda()
    marks_dev = torch.from_numpy(dp_marks).cuda()
    for prec, names in (("default", ("k1", "k4")),
                        ("highest", ("k6a", "k10"))):
        p = wm.Precision(prec)
        want = pipeline.embed(rgb_dev, marks_dev, wm.WriteConfig(precision=p))
        want_ext = pipeline.extract(rgb_dev, want, N,
                                    wm.ReadConfig(precision=p))
        equal = (bool(np.array_equal(r0["dp"][prec]["marked"],
                                     want.cpu().numpy())),
                 bool(np.array_equal(r0["dp"][prec]["ext"],
                                     want_ext.cpu().numpy())))
        log(f"parallel_{backend}_dp", precision=prec, bit_equal=equal,
            shape=list(dp_rgb.shape))
        if not all(equal):
            raise AssertionError(f"{backend} DP {prec} differs from one device")
    for r, counts in enumerate(launches):
        _need_launches(f"{backend} DP rank {r}", counts["dp"],
                       ("k1", "k4", "k6a", "k10", "k3_plane", "k3_coeffs"))
        _need_no_launches(f"{backend} DP rank {r}", counts["dp"], ("k7",))
        _need_launches(f"{backend} spatial rank {r}", counts["spatial"],
                       ("k3",))
        _need_launches(f"{backend} corpus rank {r}", counts["corpus"],
                       ("k7", "k3"))

    for i, ((shape, img), m) in enumerate(zip(sp, sp_marks)):
        got = r0["spatial"][i]
        want = pipeline.embed(torch.from_numpy(img).cuda(),
                              torch.from_numpy(m).cuda()).cpu()
        step, share = _step_share(got["marked"], want)
        own, _ = _own_cross(got["ext"][None], m[None])
        rec = dict(mesh=list(shape), shape=list(img.shape), max_step=step,
                   share_differing=share, own_sigma=own)
        log(f"parallel_{backend}_spatial", **rec)
        if step > 1 or share >= 0.02 or own <= SIGMA:
            raise AssertionError(f"{backend} spatial: {rec}")

    got = r0["corpus"]
    h = c_imgs.shape[1]
    want = pipeline.embed(torch.from_numpy(c_imgs).cuda(),
                          torch.from_numpy(c_marks[:, None]).cuda()).cpu()
    step, share = _step_share(got["marked"][:, :h], want)
    own, cross = _own_cross(got["ext"], c_marks)
    single = pipeline.extract(torch.from_numpy(c_imgs).cuda(),
                              torch.from_numpy(got["marked"][:, :h]).cuda(),
                              N).cpu().numpy()
    agree = float((np.abs(got["ext"] - single) < 5e-2).mean())
    rec = dict(mesh=[2, 2], shape=list(got["marked"].shape), max_step=step,
               share_differing=share, padding_zero=not got["marked"][:, h:].any(),
               min_own_sigma=own, max_cross_sigma=cross,
               share_within_5e_2=agree)
    log(f"parallel_{backend}_corpus", **rec)
    if (step > 1 or share >= 0.10 or not rec["padding_zero"] or own <= SIGMA
            or cross >= 4.0 or agree <= 0.99):
        raise AssertionError(f"{backend} corpus: {rec}")
    out["ranks_seconds"] = seconds
    out["rank_launches"] = launches

    mbs = _texture_batch(127, 8, 1080, 1920).reshape(4, 2, 1080, 1920, 3)
    smark = rng.standard_normal(N).astype(np.float32)
    runs = [(smark, "default"), (smark, "high")]
    t0 = time.perf_counter()
    staged = launch.run_ranks(
        dryrun.parity_rank, 3, backend=backend, device="cuda", timeout=300,
        args=({"staged": {"images": mbs, "runs": runs}}, "cuda"))
    out["staged_seconds"] = time.perf_counter() - t0
    for k, (m, prec) in enumerate(runs):
        cfg = wm.WriteConfig(precision=wm.Precision(prec))
        ref = np.stack([pipeline.embed(
            torch.from_numpy(mbs[i]).cuda(), torch.from_numpy(m[None]).cuda(),
            cfg).cpu().numpy() for i in range(mbs.shape[0])])
        equal = bool(np.array_equal(staged[-1]["staged"]["runs"][k], ref))
        log(f"parallel_{backend}_staged", precision=prec, shape=list(mbs.shape),
            bit_equal=equal,
            launches=[r["staged"]["run_launches"][k] for r in staged])
        if not equal:
            raise AssertionError(f"{backend} staged {prec} != pipeline.embed")
    if not all(r["staged"]["highest_raises"] for r in staged):
        raise AssertionError(f"{backend} staged: HIGHEST was not refused")
    # Each run's own counts: DEFAULT's first pass is K1's single mode and
    # HIGH's its high mode, never the other; the select on stage 1, K4 on
    # stage 2.
    for k, (_, prec) in enumerate(runs):
        per_stage = [r["staged"]["run_launches"][k] for r in staged]
        first, other = ("k1", "k1_high") if prec == "default" \
            else ("k1_high", "k1")
        _need_launches(f"staged {prec} stage 0", per_stage[0], (first,))
        if per_stage[0][other]:
            raise AssertionError(f"staged {prec} stage 0 launched {other}: "
                                 f"{per_stage[0]}")
        _need_launches(f"staged {prec} stage 1", per_stage[1],
                       ("k3_plane",))
        _need_launches(f"staged {prec} stage 2", per_stage[2], ("k4",))
    out["staged_run_launches"] = [r["staged"]["run_launches"]
                                  for r in staged]

    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(4, "cuda", backend=backend, timeout=300)
    log(f"parallel_{backend}_dryrun", seconds=time.perf_counter() - t0, ranks=dry)
    return out


def phase_parallel() -> None:
    """Phase 12: ``parallel/`` on the card, NCCL at world size one, then the
    multi-rank paths: with four cards or more, NCCL ranks one per card and
    the corpus-sharded bench across the cards; with fewer, gloo ranks that
    share cuda:0 (NCCL refuses two ranks on one card). Each rank's kernel
    launches are recorded."""
    import torch

    t0 = time.perf_counter()
    nccl = _parallel_nccl()
    cards = torch.cuda.device_count()
    if cards >= 4:
        ranks = _parallel_ranks("nccl")
        _multicard_corpus_bench(cards)
    else:
        ranks = _parallel_ranks("gloo")
    log("parallel", seconds=time.perf_counter() - t0, card=_card(),
        cards=cards, nccl_launches=nccl, rank_launches=ranks)


def _multicard_corpus_bench(n: int) -> None:
    """The corpus-sharded bench at its defaults on ``n`` cards, one NCCL
    rank each, at the default mesh ``(n/4, 4)`` and at ``(n, 1)``; each
    rank runs the bench, rank 0's result is logged."""
    from spread_spectrum_watermarking_torch import bench
    from spread_spectrum_watermarking_torch.parallel import launch

    for shape in (None, (n, 1)):
        t0 = time.perf_counter()
        res = launch.run_ranks(
            bench.run_corpus_sharded_bench, n, device="cuda", timeout=600,
            args=(32, 8, "4k", N, "highest", shape))[0]
        log("parallel_multicard_corpus_bench", card=_card(),
            wall_seconds=time.perf_counter() - t0, **res)
        if not (res["min_own_mark_sigma"] > SIGMA
                and res["max_cross_mark_sigma"] < SIGMA
                and res["comm_backend"] == "nccl"):
            raise AssertionError(f"multi-card corpus bench: {res}")


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
    k5_rec = {"name": "read_tail", "route": "cuda",
              "source": "spread_spectrum_watermarking_torch/csrc/read_tail.cu",
              "replaces": "spread_spectrum_watermarking_tpu/models/pipeline.py"
                          ":287 (dct2_dot_at, XLA; no pallas_call)"}
    k5_rec.update(phase_k5())
    torch.cuda.empty_cache()
    # Right after K5's phase: torch.profiler records their launches there
    # (later in the script it loses kernel records).
    k8_rec = {"name": "luma_u8", "route": "cuda",
              "source": "spread_spectrum_watermarking_torch/csrc/luma_u8.cu",
              "replaces": "spread_spectrum_watermarking_tpu/ops/colorspace.py"
                          ":64 (rgb_to_luma of u8_to_f32 :121, XLA; no "
                          "pallas_call)"}
    k8_rec.update(phase_k8())
    torch.cuda.empty_cache()
    k9_rec = {"name": "highest_read", "route": "cuda",
              "source": "spread_spectrum_watermarking_torch/csrc/"
                        "highest_read.cu",
              "replaces": "spread_spectrum_watermarking_tpu/ops/dct.py:256"
                          " (dct2_coeffs_at, XLA; no pallas_call)"}
    k9_rec.update(phase_k9())
    torch.cuda.empty_cache()
    k10_rec = {"name": "highest_inverse", "route": "cuda",
               "source": "spread_spectrum_watermarking_torch/csrc/"
                         "highest_inverse.cu",
               "replaces": "spread_spectrum_watermarking_tpu/models/"
                           "pipeline.py:41 (_sparse_idct_delta; the add, "
                           "clip and quantize :433-443; XLA, no "
                           "pallas_call)"}
    k10_rec.update(phase_k10())
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
    k3_src = "spread_spectrum_watermarking_torch/csrc/topk_select.cu"
    k3_tpu = ("spread_spectrum_watermarking_tpu/ops/ranking.py:274 "
              "(lax.approx_max_k → PartialReduce; no pallas_call)")
    k3_rec = {"name": "topk_select", "route": "cuda", "source": k3_src,
              "replaces": k3_tpu}
    k3p_rec = dict(k3_rec, name="topk_select_plane")
    k3c_rec = dict(k3_rec, name="topk_select_coeffs",
                   replaces="spread_spectrum_watermarking_tpu/ops/ranking.py"
                            ":306 (lax.top_k; no pallas_call)")
    k3_keys, k3_plane, k3_coeffs = phase_k3()
    k3_rec.update(k3_keys)
    k3p_rec.update(k3_plane)
    k3c_rec.update(k3_coeffs)
    torch.cuda.empty_cache()
    recs = {r["name"]: r for r in (k1_rec, k1p_rec, k1h_rec, k4_rec, k5_rec,
                                   k3_rec, k3p_rec)}
    phase_fast_path(wm.Precision.DEFAULT, recs)
    torch.cuda.empty_cache()
    phase_fast_path(wm.Precision.HIGH, recs)
    torch.cuda.empty_cache()
    for p in (wm.Precision.DEFAULT, wm.Precision.HIGH):
        phase_fast_path(p, recs if p is wm.Precision.DEFAULT else None,
                        rank_version=1)
        torch.cuda.empty_cache()
    phase_fast_options()
    torch.cuda.empty_cache()
    phase_custom()
    torch.cuda.empty_cache()
    phase_highest(k6a_rec, k6b_rec, k7_rec, k3c_rec, k8_rec, k9_rec, k10_rec)
    torch.cuda.empty_cache()
    phase_4k()
    torch.cuda.empty_cache()
    phase_bench()
    torch.cuda.empty_cache()
    t_cli = time.perf_counter()
    phase_cli()
    log("cli", seconds=time.perf_counter() - t_cli)
    torch.cuda.empty_cache()
    phase_parallel()
    log("done", seconds=time.perf_counter() - t0)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in order} for rec in
                                  (k1_rec, k1p_rec, k1h_rec, k4_rec, k5_rec,
                                   k6a_rec, k6b_rec, k1f_rec, k1fh_rec,
                                   k7_rec, k3_rec, k3p_rec, k3c_rec, k8_rec,
                                   k9_rec, k10_rec)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
