"""numpy-typed shim over the C++ RNG and quantization module
(``native/ssw_native.cpp``).

The counterpart of the JAX package's ``utils/_native.py``, with the same
four functions over the same extension. The port builds it from the
repository's source with ``g++`` the first time a function needs it
(:mod:`._hostbuild`), never at import. :func:`available` says whether it
could; where ``g++`` or ``Python.h`` is missing, callers (``rng_compat``)
take their pure-Python version, and a build that fails with both present
raises.
"""

from __future__ import annotations

import numpy as np

from ._hostbuild import NATIVE_DIR, HostExtension

_EXT = HostExtension("_native_impl", NATIVE_DIR / "ssw_native.cpp")
#: What the first :func:`available` call did: ``status`` ("built", "cached"
#: or "skipped"), with ``path`` and ``seconds``, or the ``missing`` tool.
BUILD_INFO = _EXT.info


def available() -> bool:
    """Build (or load) the extension on the first call; False where this
    host lacks ``g++`` or ``Python.h``."""
    return _EXT.available()


def generate_fixed_normal_sequence(seed: int, length: int) -> np.ndarray:
    buf = _EXT.module().generate_fixed_normal_sequence_bytes(seed, length)
    return np.frombuffer(buf, dtype="<f4").copy()


def chacha8_u64s(seed: int, count: int) -> np.ndarray:
    buf = _EXT.module().chacha8_u64s_bytes(seed, count)
    return np.frombuffer(buf, dtype="<u8").copy()


def quantize_u8(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    buf = _EXT.module().quantize_u8_bytes(arr.tobytes())
    return np.frombuffer(buf, dtype=np.uint8).reshape(arr.shape).copy()


def dequantize_f32(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    buf = _EXT.module().dequantize_f32_bytes(arr.tobytes())
    return np.frombuffer(buf, dtype="<f4").reshape(arr.shape).copy()
