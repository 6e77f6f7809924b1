#!/usr/bin/env python3
"""Where K9's error against an f64 read comes from, for the port that is
first on ``sys.path``, on one CUDA card; print one JSON line per case.

    PYTHONPATH=. python3 scripts/k9_errors.py

For each case (1/f textures and the harness's random u8, at 48 x 1080 x
1920 and 8 x 2160 x 3840 in both orientations, marked at HIGHEST and read
at the base's n = 1000 ranked indices; ``chip_smoke.k9_inputs``, the
inputs of its K9 phase) it reports, in units of 2^-24 times the sums'
absolute terms:

- ``d_err_kernel`` and ``d_err_cublas``: the largest error of the first
  pass's rows D against their f64 value, in units of ``2^-24 sum_s
  |C_S[a, s] y(s, l)|``: K9's pass (``ssw_dct2d_pass_rows``, the rows of
  each image's list) and cuBLAS's f32 pass of the plain route, each image's
  largest and the median of those;
- ``f64_kernel`` and ``f64_plain``: the read's error (``highest_read.
  f64_error``'s unit) of K9 and of the plain route, the largest and the
  median image's; ``imgs_kernel_better``: the images where K9's largest
  error is the smaller;
- ``kernel_D_exact_dot`` and ``cublas_D_exact_dot``: each route's D dotted
  in f64, which separates the first pass's share of the read's error from
  the dots';
- ``k9_ms``: K9's time (CUDA events, mean of 5 after a warm-up).

To compare two forms of the kernel, copy the package under the git-ignored
``build/`` (edit the copy; e.g. ``kListSteps`` in
``csrc/dct2d_fused.cu``) and run this script once with each on
``PYTHONPATH`` in one call.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import sys
from pathlib import Path

U = 2.0 ** -24
CASES = [(content, b, h, w) for content in ("textures", "random_u8")
         for b, h, w in ((48, 1080, 1920), (48, 1920, 1080),
                         (8, 2160, 3840), (8, 3840, 2160))]


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("k9_errors_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pass_rows(y, count, rows):
    """K9's first pass alone: D (b, cap, L) for each image's listed rows."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import _build
    from spread_spectrum_watermarking_torch.kernels import highest_read as k9

    b, h, w = y.shape
    s, l = min(h, w), max(h, w)
    cap = rows.shape[-1]
    pitch = -(-l // 4) * 4
    d = torch.zeros(b * cap * pitch, device=y.device)
    s_hi, s_lo = k9._short_parts(s, y.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel("ssw_dct2d_pass_rows",
                       [p, p, p, i, p, p, i, p, i, i, i, i, p])
    cnt = count.to(torch.int32).contiguous()
    lst = rows.clamp(min=0).to(torch.int32).contiguous()
    _build.check(fn(y.data_ptr(), s_hi.data_ptr(), s_lo.data_ptr(),
                    -(-s // 4) * 4, cnt.data_ptr(), lst.data_ptr(), cap,
                    d.data_ptr(), pitch, b, h, w,
                    torch.cuda.current_stream().cuda_stream),
                 "ssw_dct2d_pass_rows")
    torch.cuda.synchronize()
    return d.view(b, cap, pitch)[..., :l]


def _case(cs, content, b, h, w) -> dict:
    import torch

    from spread_spectrum_watermarking_torch.kernels import highest_read as k9
    from spread_spectrum_watermarking_torch.kernels import read_tail as k5
    from spread_spectrum_watermarking_torch.ops import dct

    y, idx = cs.k9_inputs(content, 90 + b + (h > w), b, h, w)
    land = h <= w
    s, l = min(h, w), max(h, w)
    count, rows, slot = k5.compact_rows_reference(idx, h, w, b)
    d = _pass_rows(y, count, rows)
    cs_ = dct.basis_tensor(s, y.device, torch.float32)
    cl = dct.basis_tensor(l, y.device, torch.float32).double()
    t = (dct.matmul_f32(cs_, y) if land
         else dct.matmul_f32(y, cs_.t()).transpose(-1, -2))
    out_k = k9.highest_read(y, idx)
    out_p = k9.highest_read_reference(y, idx)
    rec = {"content": content, "shape": [b, h, w],
           "k9_ms": cs.time_ms(lambda: k9.highest_read(y, idx), 5)}
    errs = {k: [] for k in ("dk", "dp", "fk", "fp", "xk", "xp")}
    for i in range(b):
        yi = (y[i] if land else y[i].t()).double()
        r = rows[i][:int(count[i])]
        ca = cs_.double()[r]
        exact = ca @ yi
        scale = U * (ca.abs() @ yi.abs())
        errs["dk"].append(float(((d[i, :r.numel()].double() - exact).abs()
                                 / scale).max()))
        errs["dp"].append(float(((t[i][r].double() - exact).abs()
                                 / scale).max()))
        bi = idx[i] % w if land else idx[i] // w
        cb, sl = cl[bi], slot[i]
        unit = (cb.abs() * scale[sl]).sum(-1)
        ex = (exact[sl] * cb).sum(-1)
        for key, v in (("fk", out_k[i].double()), ("fp", out_p[i].double()),
                       ("xk", (d[i, sl].double() * cb).sum(-1)),
                       ("xp", (t[i][r][sl].double() * cb).sum(-1))):
            errs[key].append(float(((v - ex).abs() / unit).max()))

    def med(v):
        return sorted(v)[len(v) // 2]

    rec.update(d_err_kernel=max(errs["dk"]), d_err_cublas=max(errs["dp"]),
               d_err_kernel_median=med(errs["dk"]),
               d_err_cublas_median=med(errs["dp"]),
               f64_kernel=max(errs["fk"]), f64_plain=max(errs["fp"]),
               f64_kernel_median=med(errs["fk"]),
               f64_plain_median=med(errs["fp"]),
               kernel_D_exact_dot=max(errs["xk"]),
               cublas_D_exact_dot=max(errs["xp"]),
               imgs_kernel_better=sum(a <= c for a, c in zip(errs["fk"],
                                                             errs["fp"])))
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k9_errors: no CUDA card", file=sys.stderr)
        return 2
    from spread_spectrum_watermarking_torch.kernels import highest_read

    cs = _smoke()
    card = cs._card()
    for case in CASES:
        rec = _case(cs, *case)
        print(json.dumps({"card": card, "package":
                          str(Path(highest_read.__file__).parents[1]),
                          **rec}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
