"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

All of ``csrc/*.cu`` is compiled for Hopper (``sm_90a``), one ``nvcc`` per
source started together, and linked into one shared library with a plain C
interface, under ``build/<hash>/`` inside the package
(``.gitignore`` lists ``build/``). The hash covers the sources and the flags,
so a second run loads the library it finds instead of rebuilding. Nothing
here runs at import time: :func:`kernel` builds on its first call.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises if that is not 0, since a refused launch never runs and
a later ``synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
_LIB_NAME = "libssw_kernels.so"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC")

_lib = None
#: What the first :func:`library` call did: ``path``, ``seconds``, ``cached``.
BUILD_INFO: dict = {}


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Runs the commands at once; raises with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outputs = [p.communicate() for p in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}\n{err}")


def _build(out: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then the link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [out.with_name(f"{p.stem}.{tag}.o") for p in srcs]
    tmp = out.with_name(f"{out.name}.{tag}")
    nvcc = _nvcc()
    try:
        _run_all([[nvcc, *FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(srcs, objs)])
        _run_all([[nvcc, *FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from the sources on first use."""
    global _lib
    if _lib is None:
        out = _BUILD / _digest() / _LIB_NAME
        t0 = time.perf_counter()
        cached = out.exists()
        if not cached:
            _build(out)
        lib = ctypes.CDLL(str(out))
        lib.ssw_error_string.argtypes = [ctypes.c_int]
        lib.ssw_error_string.restype = ctypes.c_char_p
        lib.ssw_topk_select_workspace.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int]
        lib.ssw_topk_select_workspace.restype = ctypes.c_longlong
        BUILD_INFO.update(path=str(out), cached=cached,
                          seconds=time.perf_counter() - t0)
        _lib = lib
    return _lib


def kernel(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name``, with its ``argtypes`` declared (pointers
    and the stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(code: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = library().ssw_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
