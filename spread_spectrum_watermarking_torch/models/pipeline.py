"""End-to-end watermarking pipelines at the ``DEFAULT`` and ``HIGHEST`` tiers.

Port of the JAX package's ``models/pipeline.py``. Functions keep the JAX
names, parameters and defaults and take ``(B, H, W, 3)`` or ``(H, W, 3)``
tensors; the device is the input's.

``Precision.HIGHEST``, the default of every config, is the reference-exact
tier: the full f32 transform (:func:`_forward`, kernel K6a on the card),
the exact selection ``ranking.top_indices``, and either the sparse inverse
of the n changed coefficients (:func:`_sparse_idct_delta`, an f32 product)
or, with ``sparse_idct=False``, the full inverse transform of the changed
plane (kernel K6b). Reads transform the derived image only at the n ranked
indices (``dct.dct2_coeffs_at``), or in full with ``sparse_derived=False``
(:func:`prepare_derived`). u8 and float RGB in, u8 or float RGB out.

``Precision.DEFAULT`` is the fast tier, on u8 images only, with the kernel
that carries each stage on the card:

1. prologue, luma + first DCT pass (:func:`_half_pass`): kernel K1;
2. second pass to the bf16 rank plane (:func:`_second_pass`): a bf16
   ``torch.matmul`` with f32 sums, as the JAX package leaves it to XLA;
3. exact top-n on sign-in-LSB keys (``ops.ranking``);
4. modulation of the n values (``ops.modulation``);
5. epilogue, sparse inverse DCT added to the u8 image: kernel K4;
6. read tail (:func:`_extract_fast_tail`): K1's pair mode, then a
   gather-dot at the n indices.

At both tiers Writer and Reader agree bit for bit because both rank the
base image through the same deterministic code (no atomics on the path).

Not ported yet, and raising ``NotImplementedError`` rather than taking
another path (ROADMAP.md, Queue 1 item 6): ``Precision.HIGH``; at DEFAULT
float RGB input and output (``quantize=False``) and ``sparse_idct=False``;
custom insert, extract and ordering callables; rank generation 1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import Method, Precision, ReadConfig, WriteConfig
from ..kernels.dct2d_fused import inverse_scale
from ..kernels.embed_epilogue import delta_plane, embed_epilogue
from ..kernels.luma_pass import luma_pass
from ..ops import colorspace, dct, modulation, ranking


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1 item 6)")


def _require_fast(precision: Precision) -> None:
    if precision is not Precision.DEFAULT:
        raise _not_ported(f"precision {precision.value!r}")


def _require_highest(precision: Precision, what: str) -> None:
    if precision is not Precision.HIGHEST:
        raise _not_ported(f"{what} at precision {precision.value!r}")


def _require_u8(rgb: torch.Tensor) -> None:
    if rgb.dtype != torch.uint8:
        raise _not_ported(f"{rgb.dtype} input at precision 'default' "
                          f"(uint8 only)")


def _to_f32(rgb: torch.Tensor) -> torch.Tensor:
    if not rgb.is_floating_point():
        return colorspace.u8_to_f32(rgb)
    return rgb.to(torch.float32)


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    """The f32 luma plane of u8 or float RGB (the u8 table for u8 images:
    the same bits as from the float path)."""
    if rgb.dtype == torch.uint8:
        return colorspace.luma_u8(rgb)
    return colorspace.rgb_to_luma(_to_f32(rgb))


def _forward(rgb: torch.Tensor, precision: Precision) -> torch.Tensor:
    """RGB (..., H, W, 3) -> the luma plane's f32 DCT (..., H, W): the
    HIGHEST prologue of Writer and Reader (kernel K6a on the card)."""
    return dct.dct2_2d(_luma(rgb), precision=precision)


def _half_pass(rgb: torch.Tensor, precision: Precision) -> torch.Tensor:
    """Luma + one DCT-II pass along the shorter axis, bf16: K1."""
    _require_fast(precision)
    return luma_pass(rgb)


def _second_pass(t: torch.Tensor, ax: int) -> torch.Tensor:
    """The second pass over the other axis: the bf16 plane the fast tier
    ranks on."""
    other = -1 if ax == -2 else -2
    return dct.dct2_pass(t, axis=other, precision=Precision.DEFAULT,
                         out_dtype=torch.bfloat16)


def _rank_from_half(t: torch.Tensor, n: int, ordering, custom_metric,
                    ax: int, rank_version: int = 2
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second pass + ranking from the half-transformed plane."""
    return ranking.approx_top_indices(_second_pass(t, ax), n, ordering,
                                      custom_metric=custom_metric,
                                      version=rank_version)


def _rank_and_values_fast(rgb: torch.Tensor, n: int, ordering, precision,
                          custom_metric=None, rank_version: int = 2
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ranked flat indices (B, n) int64 and value estimates (B, n) f32."""
    _require_u8(rgb)
    ax = dct.shorter_axis(rgb.shape[-3], rgb.shape[-2])
    t = _half_pass(rgb, precision)
    return _rank_from_half(t, n, ordering, custom_metric, ax, rank_version)


def _sparse_factors_f32(delta: torch.Tensor, idx: torch.Tensor, h: int,
                        w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k-major f32 factors of dY = (4/(W*H)) D_h[:, rows] diag(delta)
    D_w[:, cols]^T, without the scale: ``D_h[:, rows] * delta`` as
    (B, n, H) and ``D_w[:, cols]`` as (B, n, W)."""
    rows = torch.div(idx, w, rounding_mode="floor")
    cols = idx % w
    dh = dct.basis_tensor(h, delta.device, torch.float32, inverse=True)
    dw = dct.basis_tensor(w, delta.device, torch.float32, inverse=True)
    return dh.t()[rows] * delta[..., None], dw.t()[cols]


def _sparse_idct_factors(delta: torch.Tensor, idx: torch.Tensor, h: int,
                         w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's k-major bf16 factors: the scale folded into ``a`` before the
    bf16 rounding, as the JAX DEFAULT branch rounds them."""
    a, b = _sparse_factors_f32(delta, idx, h, w)
    return (a * inverse_scale(h, w)).to(torch.bfloat16), b.to(torch.bfloat16)


def _sparse_idct_delta(delta: torch.Tensor, idx: torch.Tensor, h: int,
                       w: int, precision: Precision = Precision.DEFAULT
                       ) -> torch.Tensor:
    """dY (B, H, W) of a sparse coefficient update, the plain way: bf16 at
    DEFAULT; at HIGHEST the f32 (H, n) @ (n, W) product of the factors,
    then times ``f32(4/(W*H))``, as the JAX package orders it."""
    if precision is Precision.DEFAULT:
        return delta_plane(*_sparse_idct_factors(delta, idx, h, w))
    _require_highest(precision, "the sparse inverse")
    a, b = _sparse_factors_f32(delta, idx, h, w)
    return dct.matmul_f32(a.transpose(-1, -2), b) * inverse_scale(h, w)


def _broadcast_marks(marks: torch.Tensor, batch: int) -> torch.Tensor:
    """(M, N) shared across the batch -> (B, M, N); (B, M, N) as is."""
    if marks.ndim == 2:
        return marks[None].expand(batch, *marks.shape)
    return marks


def _embed_fast(rgb: torch.Tensor, marks: torch.Tensor,
                config: WriteConfig) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Rank, modulate and write through K4: ``(marked, idx, original)``."""
    if config.custom_insert is not None:
        raise _not_ported("custom_insert")
    n = marks.shape[-1]
    h, w = rgb.shape[-3], rgb.shape[-2]
    idx, original = _rank_and_values_fast(
        rgb, n, config.ordering, config.precision, config.custom_ordering,
        config.rank_version)
    new_values = modulation.embed_marks(
        original, _broadcast_marks(marks, rgb.shape[0]),
        config.insertion.method, config.insertion.alpha)
    a, b = _sparse_idct_factors(new_values - original, idx, h, w)
    return embed_epilogue(rgb, a, b), idx, original


def _embed_highest(rgb: torch.Tensor, marks: torch.Tensor,
                   config: WriteConfig, quantize: bool, sparse_idct: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference-exact embed: ``(marked, idx, original)``, the last two
    being the base's ranked indices and f32 coefficients there, exactly
    what a Reader re-derives from the same base."""
    if config.custom_insert is not None:
        raise _not_ported("custom_insert")
    rgbf = _to_f32(rgb)
    coeffs = _forward(rgb, Precision.HIGHEST)
    b, h, w = coeffs.shape
    idx = ranking.top_indices(coeffs, marks.shape[-1], config.ordering,
                              custom_metric=config.custom_ordering)
    flat = coeffs.reshape(b, h * w)
    original = torch.gather(flat, -1, idx)
    new_values = modulation.embed_marks(
        original, _broadcast_marks(marks, b), config.insertion.method,
        config.insertion.alpha)
    if sparse_idct:
        # Only Y changes, and the Y column of YIQ->RGB is [1, 1, 1]
        # (reference src/yiq.rs:161-165), so RGB' = clamp(RGB + dY).
        dy = _sparse_idct_delta(new_values - original, idx, h, w,
                                Precision.HIGHEST)
        out = torch.clamp(rgbf + dy[..., None], 0.0, 1.0)
    else:
        # The reference's Writer::result: the full inverse of the changed
        # plane, with the base's I and Q (src/algorithm.rs:361-374).
        yiq = colorspace.rgb_to_yiq(rgbf)
        y = dct.idct2_2d(flat.scatter(-1, idx, new_values).reshape(b, h, w))
        out = colorspace.yiq_to_rgb(
            torch.stack([y, yiq[..., 1], yiq[..., 2]], dim=-1))
    if quantize:
        out = colorspace.f32_to_u8(out)
    return out, idx, original


def _extract_fast_tail(base: torch.Tensor, derived: torch.Tensor,
                       idx: torch.Tensor, base_vals: torch.Tensor,
                       config: ReadConfig,
                       sparse_second: bool = True) -> torch.Tensor:
    """Delta-exact read given the base's ranked indices and values.

    The derived image is never transformed on its own: K1's pair mode
    transforms ``luma(derived - base)`` from the exact integer difference,
    and the second pass runs only at the n indices (in full, then gathered,
    with ``sparse_second=False``).
    """
    if config.custom_extract is not None:
        raise _not_ported("custom_extract")
    _require_fast(config.precision)
    _require_u8(base)
    _require_u8(derived)
    if base.shape != derived.shape:
        raise ValueError(f"base {tuple(base.shape)} and derived "
                         f"{tuple(derived.shape)} differ in shape")
    h, w = base.shape[-3], base.shape[-2]
    ax = dct.shorter_axis(h, w)
    td = luma_pass(derived, base)
    if sparse_second:
        num = dct.dct2_dot_at(td, idx, contracted_axis=ax,
                              precision=Precision.DEFAULT)
    else:
        other = -1 if ax == -2 else -2
        dplane = dct.dct2_pass(td, axis=other, precision=Precision.DEFAULT)
        num = torch.gather(dplane.reshape(*dplane.shape[:-2], h * w), -1, idx)
    method, alpha = config.extraction.method, config.extraction.alpha
    if method == Method.OPTION1:  # (d - b) / alpha
        return num / alpha
    if method == Method.OPTION2:  # (d - b) / (b * alpha)
        return num / (base_vals * alpha)
    if method == Method.OPTION3:  # ln(d / b) / alpha = log1p(num / b) / alpha
        return torch.log1p(num / base_vals) / alpha
    raise ValueError(f"unknown method {method}")


def _read_config(config: WriteConfig) -> ReadConfig:
    return ReadConfig(extraction=config.insertion, ordering=config.ordering,
                      precision=config.precision,
                      custom_ordering=config.custom_ordering,
                      rank_version=config.rank_version)


def _extract_values(config: ReadConfig, base_vals: torch.Tensor,
                    derived_vals: torch.Tensor) -> torch.Tensor:
    if config.custom_extract is not None:
        raise _not_ported("custom_extract")
    return modulation.extract_values(config.extraction.method,
                                     config.extraction.alpha, base_vals,
                                     derived_vals)


def embed(rgb: torch.Tensor, marks: torch.Tensor,
          config: WriteConfig = WriteConfig(), quantize: bool = True,
          sparse_idct: bool = True) -> torch.Tensor:
    """Embed watermark(s) into images of ``rgb``'s shape.

    ``rgb``: u8, or (HIGHEST only) float RGB in [0, 1]. ``marks``: (N,) one
    mark, (M, N) M marks shared across the batch, or (B, M, N) per image;
    several marks add their deltas (reference: src/algorithm.rs:382-410).
    ``quantize``: u8 output (the reference's ``into_rgb8``), else f32
    (HIGHEST only). ``sparse_idct``: invert only the n changed coefficients
    (the default); False runs the reference's full inverse transform
    (HIGHEST only).
    """
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    if marks.ndim == 1:
        marks = marks[None]
    if config.precision is Precision.HIGHEST:
        marked, _, _ = _embed_highest(rgb, marks, config, quantize,
                                      sparse_idct)
    else:
        _require_fast(config.precision)
        if not sparse_idct:
            raise _not_ported("sparse_idct=False at precision 'default'")
        if not quantize:
            raise _not_ported("quantize=False at precision 'default'")
        marked, _, _ = _embed_fast(rgb, marks, config)
    return marked[0] if single else marked


def embed_verified(rgb: torch.Tensor, marks: torch.Tensor,
                   config: WriteConfig = WriteConfig(),
                   quantize: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed, then extract from the (quantized) output with the base's
    ranking: ``(marked, extracted)``, what :func:`extract` (HIGHEST) or
    :func:`rank_base` + :func:`extract_ranked` (DEFAULT) would read from
    ``marked``. The base's transform and ranking are computed once."""
    if config.custom_insert is not None:
        raise ValueError("embed_verified cannot invert a custom_insert; "
                         "use embed + extract with custom_extract")
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    if marks.ndim == 1:
        marks = marks[None]
    rconfig = _read_config(config)
    if config.precision is Precision.HIGHEST:
        marked, idx, base_vals = _embed_highest(rgb, marks, config, quantize,
                                                True)
        derived_vals = dct.dct2_coeffs_at(_luma(marked), idx)
        ext = _extract_values(rconfig, base_vals, derived_vals)
    else:
        _require_fast(config.precision)
        if not quantize:
            raise _not_ported("quantize=False at precision 'default'")
        marked, idx, original = _embed_fast(rgb, marks, config)
        ext = _extract_fast_tail(rgb, marked, idx, original, rconfig)
    if single:
        return marked[0], ext[0]
    return marked, ext


def prepare_base(rgb: torch.Tensor, n: int, config: ReadConfig = ReadConfig()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The base image's flat f32 coefficients and its top-n indices:
    ``(flat, idx)``, the HIGHEST Reader's cache (reference ``Reader::base``,
    src/algorithm.rs:462-498)."""
    _require_highest(config.precision, "prepare_base")
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    coeffs = _forward(rgb, config.precision)
    idx = ranking.top_indices(coeffs, n, config.ordering,
                              custom_metric=config.custom_ordering)
    flat = coeffs.reshape(coeffs.shape[0], -1)
    if single:
        return flat[0], idx[0]
    return flat, idx


def prepare_derived(rgb: torch.Tensor, config: ReadConfig = ReadConfig()
                    ) -> torch.Tensor:
    """A derived image's flat f32 coefficients (reference
    ``Reader::derived``, src/algorithm.rs:469-480)."""
    _require_highest(config.precision, "prepare_derived")
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    flat = _forward(rgb, config.precision).reshape(rgb.shape[0], -1)
    return flat[0] if single else flat


def extract_prepared(base_flat: torch.Tensor, idx: torch.Tensor,
                     derived_flat: torch.Tensor,
                     config: ReadConfig = ReadConfig()) -> torch.Tensor:
    """The mark from prepared coefficients: both gathered at ``idx``, then
    the inverse equation (reference ``Reader::extract_watermark``,
    src/algorithm.rs:543-562). Meaningful at HIGHEST, where both planes
    are f32-exact."""
    return _extract_values(config, torch.gather(base_flat, -1, idx),
                           torch.gather(derived_flat, -1, idx))


def rank_base(rgb: torch.Tensor, n: int, config: ReadConfig = ReadConfig()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The base image's ranked ``(indices, values)`` on the fast tier, the
    DEFAULT Reader's cache (reference ``Reader::base``,
    src/algorithm.rs:462-498)."""
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    idx, vals = _rank_and_values_fast(
        rgb, n, config.ordering, config.precision, config.custom_ordering,
        config.rank_version)
    if single:
        return idx[0], vals[0]
    return idx, vals


def rank_plane(rgb: torch.Tensor,
               precision: Precision = Precision.HIGHEST) -> torch.Tensor:
    """The (H, W) f32 coefficient plane the given tier ranks on: the exact
    f32 transform at HIGHEST, the bf16 two-pass plane at DEFAULT."""
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    if precision is Precision.HIGHEST:
        out = _forward(rgb, precision)
    else:
        _require_fast(precision)
        _require_u8(rgb)
        ax = dct.shorter_axis(rgb.shape[-3], rgb.shape[-2])
        out = _second_pass(_half_pass(rgb, precision), ax).to(torch.float32)
    return out[0] if single else out


def extract_ranked(base: torch.Tensor, derived: torch.Tensor,
                   idx: torch.Tensor, base_vals: torch.Tensor,
                   config: ReadConfig = ReadConfig()) -> torch.Tensor:
    """Extract the mark from ``derived`` given :func:`rank_base` output."""
    single = base.ndim == 3
    if single:
        base, derived = base[None], derived[None]
        idx, base_vals = idx[None], base_vals[None]
    out = _extract_fast_tail(base, derived, idx, base_vals, config)
    return out[0] if single else out


def _extract_fused(base: torch.Tensor, derived: torch.Tensor, n: int,
                   config: ReadConfig, sparse_second: bool = True
                   ) -> torch.Tensor:
    """Batched read: the base's full transform and ranking, the derived
    image's coefficients at the n indices only (HIGHEST), or the fast
    tier's delta-exact read (DEFAULT)."""
    if config.precision is not Precision.HIGHEST:
        idx, base_vals = _rank_and_values_fast(
            base, n, config.ordering, config.precision,
            config.custom_ordering, config.rank_version)
        return _extract_fast_tail(base, derived, idx, base_vals, config,
                                  sparse_second)
    coeffs = _forward(base, config.precision)
    idx = ranking.top_indices(coeffs, n, config.ordering,
                              custom_metric=config.custom_ordering)
    base_vals = torch.gather(coeffs.reshape(coeffs.shape[0], -1), -1, idx)
    derived_vals = dct.dct2_coeffs_at(_luma(derived), idx)
    return _extract_values(config, base_vals, derived_vals)


def extract(base: torch.Tensor, derived: torch.Tensor, n: int,
            config: ReadConfig = ReadConfig(),
            sparse_derived: bool = True) -> torch.Tensor:
    """Extract length-``n`` watermark(s) from ``derived`` against ``base``
    (both (B, H, W, 3) or (H, W, 3)), at the tier the mark was embedded at.

    ``sparse_derived`` (default) computes the derived image's coefficients
    only at the n ranked indices; False forces the full second transform.
    Raises ValueError where the reference panics (src/algorithm.rs:550-555):
    images of different sizes, or ``n`` not below the coefficient count.
    """
    if base.shape != derived.shape:
        raise ValueError(
            "Derived coefficient length not equal to base coefficient length: "
            f"base {tuple(base.shape)} vs derived {tuple(derived.shape)}")
    h, w = base.shape[-3], base.shape[-2]
    if n >= h * w:
        raise ValueError(
            "Desired extraction length exceeds available coefficients.")
    if sparse_derived or config.precision is not Precision.HIGHEST:
        single = base.ndim == 3
        if single:
            base, derived = base[None], derived[None]
        out = _extract_fused(base, derived, n, config,
                             sparse_second=sparse_derived)
        return out[0] if single else out
    base_flat, idx = prepare_base(base, n, config)
    return extract_prepared(base_flat, idx, prepare_derived(derived, config),
                            config)


similarity = modulation.similarity
