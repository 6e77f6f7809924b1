"""The PyTorch port stands alone: importing it pulls in no JAX."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "spread_spectrum_watermarking_torch"

_PROBE = """
import sys
import spread_spectrum_watermarking_torch
import spread_spectrum_watermarking_torch.interop
import spread_spectrum_watermarking_torch.bench
import spread_spectrum_watermarking_torch.cli
from spread_spectrum_watermarking_torch.utils import (_codec, _native, debug,
                                                      image_io, rng_compat,
                                                      storage)
from spread_spectrum_watermarking_torch.kernels import _build
import spread_spectrum_watermarking_torch.parallel
from spread_spectrum_watermarking_torch.parallel import (dct_sharded, dryrun,
                                                         launch, mesh,
                                                         pipeline_sharded,
                                                         pipeline_staged,
                                                         topk_sharded)
loaded = [m for m in sys.modules
          if m.split('.')[0] in ('jax', 'jaxlib', 'spread_spectrum_watermarking_tpu')]
built = [_build._lib, _native.BUILD_INFO, _codec.BUILD_INFO]
print(loaded, built)
sys.exit(1 if loaded or any(built) else 0)
"""


def test_import_loads_no_jax_and_builds_nothing():
    # A subprocess: this test process has already imported jax (conftest).
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|spread_spectrum_watermarking_tpu)\b",
    re.MULTILINE)


def test_no_port_file_imports_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 10
    offenders = [str(p) for p in files if _JAX_IMPORT.search(p.read_text())]
    assert offenders == []
