#!/usr/bin/env python3
"""Measure the TF32 tensor-core rate that ``mma.sync.m16n8k8`` reaches on
one CUDA card, the instruction K6a/K6b (``csrc/dct2d_fused.cu``) issue, and
print one JSON line.

Run from the repository root on a machine with a card and ``nvcc``::

    python3 scripts/mma_peak.py

Each warp issues chains of independent ``mma.sync.m16n8k8.tf32`` on
operands held in registers (no memory traffic), at 1 and 2 blocks of 256
threads per SM; the rate is 2 * 16 * 8 * 8 operations an instruction over
the CUDA-event time of one launch after a warm-up. The source is compiled
with the port's ``nvcc`` flags into ``build/mma_peak/`` (git-ignored).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (0x3f800000u + (threadIdx.x << 13)) & 0xffffe000u;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f000000u;
  float c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.0f;
  for (int j = 0; j < kChains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 1234.5f) out[threadIdx.x] = s;
}

extern "C" int mma_peak(float* out, int blocks, int iters, cudaStream_t stream) {
  mma_loop<<<blocks, 256, 0, stream>>>(out, iters);
  return int(cudaGetLastError());
}
"""
_CHAINS = 16


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_peak: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from spread_spectrum_watermarking_torch.kernels import _build

    out_dir = Path(__file__).resolve().parent.parent / "build" / "mma_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "mma_peak.cu", out_dir / "libmma_peak.so"
    src.write_text(_SRC)
    subprocess.run([_build._nvcc(), *_build.FLAGS, f"-DkChains={_CHAINS}",
                    "-shared", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    lib.mma_peak.restype = ctypes.c_int

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.zeros(256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    result = {"card": smi, "sms": sms, "chains_per_warp": _CHAINS}
    iters = 20000
    for per_sm in (1, 2):
        blocks = sms * per_sm
        if lib.mma_peak(buf.data_ptr(), blocks, 100, stream) != 0:
            raise RuntimeError("mma_peak: launch refused")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lib.mma_peak(buf.data_ptr(), blocks, iters, stream)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        ops = blocks * 8 * iters * _CHAINS * 2 * 16 * 8 * 8
        result[f"tflops_{per_sm}_block_per_sm"] = ops / (ms * 1e9)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
