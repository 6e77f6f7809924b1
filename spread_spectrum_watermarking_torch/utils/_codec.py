"""numpy-typed shim over the C++ codec module (``native/ssw_codec.cpp``:
libjpeg and libpng).

The counterpart of the JAX package's ``utils/_codec.py``. The port builds
the repository's source with ``g++ ... -ljpeg -lpng`` the first time
:func:`available` is called (:mod:`._hostbuild`), never at import, and only
where the ``jpeglib.h`` and ``png.h`` headers are found, the probe of
``native/setup.py``; without them the build is skipped, recorded in
:data:`BUILD_INFO`, and ``image_io`` uses PIL. With them a failed build
raises. The decoder gives PIL's pixels (the same libjpeg, JDCT_ISLOW; PNG
alpha dropped without compositing, like ``.convert("RGB")``) and releases
the GIL during codec work, so the threaded batch loader scales across
cores. It is a host codec: no pixel of it is decoded on the card.
"""

from __future__ import annotations

import numpy as np

from ._hostbuild import NATIVE_DIR, HostExtension

_EXT = HostExtension("_codec_impl", NATIVE_DIR / "ssw_codec.cpp",
                     libs=("jpeg", "png"), headers=("jpeglib.h", "png.h"))
#: What the first :func:`available` call did: ``status`` ("built", "cached"
#: or "skipped"), with ``path`` and ``seconds``, or what was ``missing``.
BUILD_INFO = _EXT.info


def available() -> bool:
    """Build (or load) the codec on the first call; False where this host
    lacks ``g++``, ``Python.h`` or the libjpeg and libpng headers."""
    return _EXT.available()


def decode_rgb_u8(data: bytes) -> np.ndarray:
    """JPEG/PNG file bytes -> (H, W, 3) uint8 RGB.

    Raises ValueError for formats the native module does not handle (callers
    fall back to PIL).
    """
    rgb, h, w = _EXT.module().decode_rgb_bytes(data)
    return np.frombuffer(rgb, dtype=np.uint8).reshape(h, w, 3).copy()


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG file bytes."""
    arr = np.ascontiguousarray(rgb_u8, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) u8, got {arr.shape}")
    return _EXT.module().encode_png_bytes(arr.tobytes(), arr.shape[0],
                                          arr.shape[1])
