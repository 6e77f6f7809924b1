"""Host-side image decode/encode (the reference's ``image`` crate layer).

The reference leans on the Rust ``image`` crate for JPEG/PNG codecs and the
u8<->f32 conversions (reference: Cargo.toml:9, SURVEY.md layer 0). Here the
C++ codec module (native/ssw_codec.cpp: libjpeg + libpng, GIL released
during codec work, PIL-parity pixels) plays that role when built, with PIL
as the always-available fallback and the decoder for any other format;
quantization semantics live in :mod:`..ops.colorspace` so device and host
paths agree exactly.

A copy of the JAX package's module. The codec is not built for the port
yet (:mod:`._codec` raises ImportError), so PIL is the path.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..ops import colorspace


try:
    from . import _codec  # C++ libjpeg/libpng codec; optional
except ImportError:  # pragma: no cover - build-dependent
    _codec = None


def load_rgb_u8(path: str | os.PathLike) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB.

    Dispatches to the native codec (byte-identical pixels to the PIL path,
    tests/test_native.py) and falls back to PIL for formats it does not
    handle or when the extension is not built.
    """
    if _codec is not None:
        with open(path, "rb") as f:
            data = f.read()
        try:
            return _codec.decode_rgb_u8(data)
        except ValueError:
            pass  # not JPEG/PNG (or an exotic variant): PIL handles it
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_rgb_f32(path: str | os.PathLike) -> np.ndarray:
    """Decode to (H, W, 3) float32 in [0, 1] (``into_rgb32f`` semantics)."""
    return colorspace.np_u8_to_f32(load_rgb_u8(path))


def save_rgb(path: str | os.PathLike, rgb: np.ndarray) -> None:
    """Encode (H, W, 3) uint8 or float32 RGB to a file (format by extension).

    float32 input is quantized with the reference's ``into_rgb8`` rounding
    (clamp, *255, round-half-away-from-zero; examples/main.rs:278).
    """
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = colorspace.np_f32_to_u8(arr.astype(np.float32))
    if _codec is not None and str(path).lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(_codec.encode_png(arr))
        return
    from PIL import Image

    Image.fromarray(arr, mode="RGB").save(path)


def load_batch_u8(paths: Sequence[str | os.PathLike], num_threads: int = 8) -> list:
    """Decode many images concurrently (PIL releases the GIL during decode).

    A minimal prefetching data loader for the batch pipelines; returns a list
    of (H, W, 3) uint8 arrays in input order.
    """
    from concurrent.futures import ThreadPoolExecutor

    if len(paths) <= 1:
        return [load_rgb_u8(p) for p in paths]
    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        return list(ex.map(load_rgb_u8, paths))
