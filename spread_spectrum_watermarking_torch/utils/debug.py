"""Debug/visualization helpers (reference: src/util.rs)."""

from __future__ import annotations

import os

import numpy as np


def dump_buffer_as_image(data: np.ndarray, path: str | os.PathLike) -> None:
    """Normalize a 2-D f32 buffer and write it as a grayscale PNG.

    Skips the DC term when computing the normalization range so the result is
    remotely viewable (reference: src/util.rs:7-21).
    """
    from PIL import Image

    arr = np.asarray(data, dtype=np.float32)
    flat = arr.reshape(-1)
    lo = flat[1:].min()
    hi = flat[1:].max()
    img = (((arr - lo) / (hi - lo)) * 255.0).astype(np.uint8)
    Image.fromarray(img, mode="L").save(path)


def approx_equal(a, b, max_error: float) -> None:
    """Assert elementwise |a-b| <= max_error (reference: src/util.rs:24-43)."""
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    if a.shape != b.shape:
        raise AssertionError("a and b are not equal length")
    delta = np.abs(a - b)
    worst = int(np.argmax(delta))
    if delta[worst] > max_error:
        raise AssertionError(
            f"a[{worst}]={a[worst]}, b[{worst}]={b[worst]}, delta "
            f"{delta[worst]} exceeded allowed {max_error}")
