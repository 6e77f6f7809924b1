"""Host-side image decode/encode (the reference's ``image`` crate layer).

The reference leans on the Rust ``image`` crate for JPEG/PNG codecs and the
u8<->f32 conversions (reference: Cargo.toml:9, SURVEY.md layer 0). Here the
C++ codec module (native/ssw_codec.cpp: libjpeg + libpng, GIL released
during codec work, PIL-parity pixels) plays that role when built, with PIL
as the always-available fallback and the decoder for any other format;
quantization semantics live in :mod:`..ops.colorspace` so device and host
paths agree exactly.

A copy of the JAX package's module, but for when the codec is looked for:
at the first decode or encode, where :mod:`._codec` builds it from the
repository's source if this host has the libjpeg and libpng headers, not
at import.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..ops import colorspace


def _native_codec():
    """The C++ libjpeg/libpng codec where it is built for this host, else
    None (PIL)."""
    from . import _codec

    return _codec if _codec.available() else None


def load_rgb_u8(path: str | os.PathLike) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB.

    Dispatches to the native codec (byte-identical pixels to the PIL path,
    tests/test_native.py) and falls back to PIL for formats it does not
    handle or when the extension is not built.
    """
    codec = _native_codec()
    if codec is not None:
        with open(path, "rb") as f:
            data = f.read()
        try:
            return codec.decode_rgb_u8(data)
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
    codec = _native_codec() if str(path).lower().endswith(".png") else None
    if codec is not None:
        with open(path, "wb") as f:
            f.write(codec.encode_png(arr))
        return
    from PIL import Image

    Image.fromarray(arr, mode="RGB").save(path)


def load_batch_u8(paths: Sequence[str | os.PathLike], num_threads: int = 8,
                  return_errors: bool = False) -> list:
    """Decode many images concurrently (PIL releases the GIL during decode).

    A minimal prefetching data loader for the batch pipelines; returns a list
    of (H, W, 3) uint8 arrays in input order. With ``return_errors`` a path
    whose decode raises gives its exception in its place instead, and the
    rest still decode.
    """
    from concurrent.futures import ThreadPoolExecutor

    load = _load_or_error if return_errors else load_rgb_u8
    if len(paths) <= 1:
        return [load(p) for p in paths]
    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        return list(ex.map(load, paths))


def _load_or_error(path: str | os.PathLike):
    try:
        return load_rgb_u8(path)
    except Exception as e:  # noqa: BLE001 -- the caller isolates each path
        return e
