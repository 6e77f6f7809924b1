"""Build the repository's C++ host extensions (``native/``) at first use.

``native/ssw_native.cpp`` (the reference's seeded RNG and the u8
quantization) and ``native/ssw_codec.cpp`` (libjpeg and libpng) are
compiled with ``g++`` and the flags of ``native/setup.py``, read from the
repository as they are, into ``build/host-<hash>/`` inside the package
(``.gitignore`` lists ``build/``), and imported under the port's own module
names. The hash covers the source, the flags, the libraries, the
interpreter's headers and extension suffix, the compiler's version and
the machine's architecture, so a later process loads the library it
finds, and a tree copied to another host builds its own. Each build writes a name of its own and renames it into place, so
processes that build at once leave one whole library. Nothing here runs at
import time.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import platform
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_ROOT = _PKG / "build"
# native/setup.py's extra_compile_args, and what setuptools adds for a
# shared extension.
FLAGS = ("-O3", "-std=c++17", "-Wall", "-shared", "-fPIC")


def _missing(gxx: str | None, include: str, headers: tuple) -> str | None:
    """The first of ``g++``, ``Python.h`` and ``headers`` this host lacks.
    The headers are probed as ``native/setup.py:_codec_headers_available``
    does, by preprocessing an include of each."""
    if gxx is None:
        return "g++"
    if not os.path.exists(os.path.join(include, "Python.h")):
        return "Python.h"
    if headers:
        probe = "".join(f"#include <{h}>\n" for h in ("stdio.h", *headers))
        proc = subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                              input=probe, capture_output=True, text=True)
        if proc.returncode != 0:
            return " and ".join(headers)
    return None


class HostExtension:
    """One extension module of ``native/``, built and imported on the first
    :meth:`available` call.

    ``info`` records what that call did: ``status`` "built" or "cached" with
    ``path`` and ``seconds``, or "skipped" with the ``missing`` tool or
    header. A host without ``g++``, ``Python.h`` or ``headers`` skips the
    build and callers take their plain version; a host with them all raises
    if the build fails, rather than ship the slower path unnoticed.
    """

    def __init__(self, module: str, source: Path, libs: tuple = (),
                 headers: tuple = (), build_root: Path = BUILD_ROOT):
        self.module_name = module
        self.source = Path(source)
        self.libs = tuple(libs)
        self.headers = tuple(headers)
        self.build_root = Path(build_root)
        self.info: dict = {}
        self._module = None
        self._lock = threading.Lock()  # threaded image loaders race here

    def available(self) -> bool:
        with self._lock:
            if not self.info:
                self._load()
        return self._module is not None

    def module(self):
        """The imported extension; ImportError where it was skipped."""
        if not self.available():
            raise ImportError(f"{self.module_name} is not built: "
                              f"{self.info['missing']} not found")
        return self._module

    def _load(self) -> None:
        t0 = time.perf_counter()
        gxx = shutil.which("g++")
        include = sysconfig.get_paths()["include"]
        missing = _missing(gxx, include, self.headers)
        if missing is None and not self.source.exists():
            missing = str(self.source)
        if missing is not None:
            self.info.update(status="skipped", missing=missing)
            return
        cmd_flags = (*FLAGS, "-I" + include)
        suffix = sysconfig.get_config_var("EXT_SUFFIX")
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join((*cmd_flags, *self.libs, suffix,
                           platform.machine())).encode())
        h.update(_compiler_version(gxx).encode())
        out = (self.build_root / f"host-{h.hexdigest()[:16]}"
               / f"{self.module_name}{suffix}")
        cached = out.exists()
        if not cached:
            _compile(gxx, cmd_flags, self.source, self.libs, out)
        spec = importlib.util.spec_from_file_location(
            f"{__package__}.{self.module_name}", out)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        self._module = mod
        self.info.update(status="cached" if cached else "built",
                         path=str(out), seconds=time.perf_counter() - t0)


def _compiler_version(gxx: str) -> str:
    return subprocess.run([gxx, "--version"], capture_output=True,
                          text=True).stdout


def _compile(gxx: str, flags: tuple, source: Path, libs: tuple,
             out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx, *flags, str(source), "-o", str(tmp), *(f"-l{l}" for l in libs)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
