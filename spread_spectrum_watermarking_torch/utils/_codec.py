"""numpy-typed shim over the C++ codec module (built from native/ssw_codec.cpp).

A copy of the JAX package's loader; no build of the extension for the port
exists yet, so importing this module raises ImportError.

Importing this module raises ImportError when the compiled extension is
absent; callers (image_io) fall back to PIL. The native decoder produces
PIL-parity pixels (same libjpeg, JDCT_ISLOW; PNG alpha stripped without
compositing like ``.convert("RGB")``) and releases the GIL during codec
work, so the threaded batch loader scales across cores.
"""

from __future__ import annotations

import numpy as np

from . import _codec_impl  # the compiled extension; ImportError if not built


def decode_rgb_u8(data: bytes) -> np.ndarray:
    """JPEG/PNG file bytes -> (H, W, 3) uint8 RGB.

    Raises ValueError for formats the native module does not handle (callers
    fall back to PIL).
    """
    rgb, h, w = _codec_impl.decode_rgb_bytes(data)
    return np.frombuffer(rgb, dtype=np.uint8).reshape(h, w, 3).copy()


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG file bytes."""
    arr = np.ascontiguousarray(rgb_u8, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) u8, got {arr.shape}")
    return _codec_impl.encode_png_bytes(arr.tobytes(), arr.shape[0], arr.shape[1])
