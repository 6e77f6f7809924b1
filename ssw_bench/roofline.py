"""The least time of each kernel's work on one NVIDIA H100 SXM: the
operations and bytes of the function a kernel computes, from the
request's shapes and, where the work depends on the data, from the rows
its ranked indices need.

Counts are of the function's work, not of a kernel's way of doing it:
- A DCT pass counts the even/odd folded product, half the dense product's
  operations (the port's fold, K1f, already does so), at the tier's
  arithmetic: bf16 at ``DEFAULT``; three TF32 products at ``HIGHEST``.
- A pass restricted to the distinct rows of the ranked indices (K5, K9,
  K10) counts those rows only.
- Each input byte is read once and each output byte written once.

A kernel's share of its roofline is its least time, the larger of its
operations over the peak of their type and its bytes over the memory's
bandwidth, over the device time of its kernels in the trace.
"""

from __future__ import annotations

#: Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
#: sheet): operations per second by type, and bytes per second of HBM3.
PEAKS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
BANDWIDTH = 3.35e12


def least_seconds(flops: float, peak: str, nbytes: float):
    """``(seconds, "operations" | "bytes")``: the bound and which side
    sets it."""
    ops = flops / PEAKS[peak] if flops else 0.0
    mem = nbytes / BANDWIDTH
    return (ops, "operations") if ops >= mem else (mem, "bytes")


# Every count below takes the work of the traced window, ``work``: the
# configuration ``cfg`` and ``requests``, a list of dicts with the request's
# ``images`` and, where the reference ranked them, ``rows``: the distinct
# rows of each image's ranked indices. It returns (flops, peak, bytes).

def _pixels(cfg) -> int:
    return cfg["height"] * cfg["width"]


def k1(cfg, requests):
    """Luma, then one DCT pass over H, bf16 out (one call a request)."""
    h, w = cfg["height"], cfg["width"]
    b = sum(r["images"] for r in requests)
    return (b * h * h * w, "bf16",
            b * _pixels(cfg) * (3 + 2) + len(requests) * h * h * 2)


def k2(cfg, requests):
    """The second pass, over W, bf16 in and out."""
    h, w = cfg["height"], cfg["width"]
    b = sum(r["images"] for r in requests)
    return (b * h * w * w, "bf16",
            b * _pixels(cfg) * (2 + 2) + len(requests) * w * w * 2)


def k3(cfg, requests):
    """The top-n of each plane: bf16 planes at the fast tiers (indices and
    f32 estimates out), f32 planes at HIGHEST (indices out)."""
    b = sum(r["images"] for r in requests)
    if cfg["precision"] == "highest":
        return 0, "f32", b * (_pixels(cfg) * 4 + cfg["n"] * 8)
    return 0, "bf16", b * (_pixels(cfg) * 2 + cfg["n"] * 12)


def k4(cfg, requests):
    """The sparse inverse (H, n) x (n, W) added to the u8 image."""
    h, w, n = cfg["height"], cfg["width"], cfg["n"]
    b = sum(r["images"] for r in requests)
    return (b * 2 * h * w * n, "bf16",
            b * (_pixels(cfg) * 3 * 2 + n * 12))


def k5(cfg, requests):
    """The fast read: the pass over H at each image's distinct rows, the
    dots at the n indices; derived and base u8 in, n f32 out."""
    h, w, n = cfg["height"], cfg["width"], cfg["n"]
    flops = sum(sum(r["rows"]) * h * w + r["images"] * 2 * n * w
                for r in requests)
    nbytes = sum(r["images"] * (2 * _pixels(cfg) * 3 + n * 12)
                 for r in requests)
    return flops, "bf16", nbytes


def k6a(cfg, requests):
    """HIGHEST's 2-D transform: f32 luma in, f32 plane out, three TF32
    products."""
    h, w = cfg["height"], cfg["width"]
    b = sum(r["images"] for r in requests)
    return 3 * b * h * w * (h + w), "tf32", b * _pixels(cfg) * 8


def k8(cfg, requests):
    """HIGHEST's u8 luma: u8 RGB in, f32 out, ``k8_calls`` a request."""
    b = sum(r["images"] * r.get("k8_calls", 1) for r in requests)
    return 0, "f32", b * _pixels(cfg) * (3 + 4)


def k9(cfg, requests):
    """HIGHEST's read at the distinct rows: f32 luma in, n f32 out."""
    h, w, n = cfg["height"], cfg["width"], cfg["n"]
    flops = sum(3 * sum(r["rows"]) * h * w + r["images"] * 2 * n * w
                for r in requests)
    b = sum(r["images"] for r in requests)
    return flops, "tf32", b * (_pixels(cfg) * 4 + n * 12)


def k10(cfg, requests):
    """HIGHEST's sparse inverse over the distinct rows, added to the u8
    image: u8 in and out."""
    h, w, n = cfg["height"], cfg["width"], cfg["n"]
    flops = sum(3 * sum(r["rows"]) * h * w + r["images"] * 2 * n * w
                for r in requests)
    b = sum(r["images"] for r in requests)
    return flops, "tf32", b * (_pixels(cfg) * 3 * 2 + n * 12)


def sweep(cfg, requests):
    """The similarity of each extraction with every candidate mark, f32
    with TF32 off: the candidates, the extractions in, sigmas out."""
    n = cfg["n"]
    flops = sum(2 * r["images"] * n * r["candidates"] for r in requests)
    nbytes = sum(r["candidates"] * n * 4 + r["images"] * n * 4
                 + r["images"] * r["candidates"] * 4 for r in requests)
    return flops, "f32", nbytes
