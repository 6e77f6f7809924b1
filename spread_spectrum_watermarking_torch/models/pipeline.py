"""End-to-end watermarking pipelines at the three precision tiers.

Port of the JAX package's ``models/pipeline.py``. Functions keep the JAX
names, parameters and defaults and take ``(B, H, W, 3)`` or ``(H, W, 3)``
tensors, u8 or float RGB in [0, 1]; the device is the input's.

``Precision.HIGHEST``, the default of every config, is the reference-exact
tier: the full f32 transform (:func:`_forward`, kernel K6a on the card),
the exact selection ``ranking.top_indices``, and either the sparse inverse
of the n changed coefficients (kernel K10 on the card, over each image's
distinct rows; its plain version, an f32 product of the factors, on the
CPU) or, with ``sparse_idct=False``, the full inverse transform of the
changed plane (kernel K6b). The luma of a u8 image is kernel K8 on the
card. Reads transform the derived image only at the n ranked indices
(kernel K9 on a u8 image on the card, ``dct.dct2_coeffs_at`` otherwise),
or in full with ``sparse_derived=False`` (:func:`prepare_derived`).

``Precision.HIGH`` and ``Precision.DEFAULT`` are the fast tiers. They
differ only in the base image's first pass; on a u8 image each stage runs
on the card as follows:

1. prologue, luma + first DCT pass (:func:`_half_pass`): kernel K1, in its
   single mode (bf16 pass) at DEFAULT and its high mode (bf16x3 pass) at
   HIGH;
2. second pass to the bf16 rank plane (:func:`_second_pass`): a bf16
   ``torch.matmul`` with f32 sums at both tiers, as the JAX package leaves
   it to XLA;
3. exact top-n on sign-in-LSB keys (``ops.ranking``);
4. modulation of the n values (``ops.modulation``);
5. epilogue, sparse bf16 inverse DCT added to the u8 image: kernel K4;
6. read tail (:func:`_extract_fast_tail`): kernel K5
   (``..kernels.read_tail``), the pair luma's first pass at the ranked
   rows only and the dots at the n indices, at DEFAULT for both tiers; K1's
   pair mode and the full second pass with ``sparse_derived=False``.

Float images, float output (``quantize=False``), the full inverse
(``sparse_idct=False``) and the prepared base/derived pair run the JAX
package's XLA forms as plain PyTorch ops at the fast tiers (a u8 image's
float output through kernel K7's f32 mode): the TPU kernels took u8
images only. At both fast tiers Writer and Reader agree bit for bit
because both rank the base image through the same deterministic code (no
atomics on the path).

The HIGHEST sparse embed adds dY to a u8 image with the sum rounded once,
as XLA's FMA rounds it. Quantized to u8, kernel K10
(``..kernels.highest_inverse``) does it in the same kernel as dY, with
K7's rounding; with ``quantize=False``, or for a float image, K10's dY mode
goes into ``colorspace.add_luma_delta_f32`` (K7's f32 mode for a u8
image), as for the fast tiers' u8 float output.

Rank generation 1 (``rank_version=1``) and the custom insert, extract and
ordering callables (torch callables, with the JAX package's signatures)
run through every entry point that the JAX package routes them through,
on the same kernels. No pipeline folds (``dct.dct2_2d(fold=True)``, kernel
K1f), as no JAX pipeline does.

Under a ``torch.profiler`` session each entry point and stage is a span
of ``..trace`` (and a profiler range of the same name): the
entry points as ``ssw.<name>``, and inside them the JAX pipeline's
profiler scopes ``ssw.forward`` (transform and ranking of the base),
``ssw.rank`` (the selection) and ``ssw.inverse`` (the inverse transform
and the epilogue), and ``ssw.read`` (the derived image's coefficients at
the ranked indices and the extraction). Without a profiler they cost a
flag read.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import trace
from ..config import Method, Precision, ReadConfig, WriteConfig
from ..kernels.dct2d_fused import inverse_scale
from ..kernels.embed_epilogue import delta_plane, embed_epilogue
from ..kernels.highest_inverse import highest_inverse, sparse_delta
from ..kernels.highest_read import highest_read
from ..kernels.luma_pass import luma_pass
from ..kernels.read_tail import read_tail
from ..ops import colorspace, dct, modulation, ranking


def _forward(rgb: torch.Tensor, precision: Precision) -> torch.Tensor:
    """RGB (..., H, W, 3) -> the luma plane's f32 DCT (..., H, W) at the
    tier: the prologue of the HIGHEST Writer and Reader (kernels K8, the u8
    luma, and K6a on the card) and of ``prepare_base``/``prepare_derived``
    at every tier."""
    return dct.dct2_2d(colorspace.luma(rgb), precision=precision)


def _read_highest(derived: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The derived image's f32 coefficients at the n ranked indices, the
    HIGHEST read: for a u8 image kernel K8's luma, then kernel K9 (the
    first pass at the indices' distinct rows only, 3xTF32, then the dots)
    on the card and its plain version, ``dct.dct2_coeffs_at``, on the CPU;
    for other images ``dct.dct2_coeffs_at`` of the f32 luma."""
    with trace.span("ssw.read"):
        y = colorspace.luma(derived)
        if derived.dtype == torch.uint8:
            return highest_read(y, idx)
        return dct.dct2_coeffs_at(y, idx)


def _half_pass(rgb: torch.Tensor, precision: Precision) -> torch.Tensor:
    """Luma + one DCT-II pass along the shorter axis.

    A u8 image at DEFAULT or HIGH runs kernel K1 (bf16 out). Otherwise the
    JAX package's XLA form runs as plain ops: the f32 luma, then the tier's
    pass, bf16 at DEFAULT (on the bf16 luma) and f32 at HIGH and HIGHEST.
    The TPU kernel never took float input (its ``supported()`` required
    uint8), so float images are a dtype route with no kernel behind it.
    """
    if rgb.dtype == torch.uint8 and precision is not Precision.HIGHEST:
        return luma_pass(rgb.contiguous(), precision=precision)
    ax = dct.shorter_axis(rgb.shape[-3], rgb.shape[-2])
    y = colorspace.luma(rgb)
    if precision is Precision.DEFAULT:
        return dct.dct2_pass(y.to(torch.bfloat16), axis=ax,
                             precision=Precision.DEFAULT,
                             out_dtype=torch.bfloat16)
    return dct.dct2_pass(y, axis=ax, precision=precision)


def _second_pass(t: torch.Tensor, ax: int) -> torch.Tensor:
    """The second pass over the other axis, on the bf16-rounded first pass:
    the bf16 plane both fast tiers rank on."""
    other = -1 if ax == -2 else -2
    return dct.dct2_pass(t.to(torch.bfloat16), axis=other,
                         precision=Precision.DEFAULT, out_dtype=torch.bfloat16)


def _rank_from_half(t: torch.Tensor, n: int, ordering, custom_metric,
                    ax: int, rank_version: int = 2
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second pass + ranking from the half-transformed plane."""
    plane = _second_pass(t, ax)
    with trace.span("ssw.rank"):
        return ranking.approx_top_indices(plane, n, ordering,
                                          custom_metric=custom_metric,
                                          version=rank_version)


def _rank_and_values_fast(rgb: torch.Tensor, n: int, ordering, precision,
                          custom_metric=None, rank_version: int = 2
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ranked flat indices (B, n) int64 and value estimates (B, n) f32."""
    ax = dct.shorter_axis(rgb.shape[-3], rgb.shape[-2])
    t = _half_pass(rgb, precision)
    return _rank_from_half(t, n, ordering, custom_metric, ax, rank_version)


def _sparse_idct_delta(delta: torch.Tensor, idx: torch.Tensor, h: int,
                       w: int, precision: Precision = Precision.DEFAULT
                       ) -> torch.Tensor:
    """dY (B, H, W) of a sparse coefficient update: bf16 at DEFAULT; K10's
    dY mode at HIGHEST (``..kernels.highest_inverse.sparse_delta``, whose
    plain version is the f32 product below); otherwise the (H, n) @ (n, W)
    product of the factors at the tier, then times ``f32(4/(W*H))``, as
    the JAX package orders it."""
    if precision is Precision.DEFAULT:
        return delta_plane(*dct.sparse_idct_factors(delta, idx, h, w))
    if precision is Precision.HIGHEST:
        return sparse_delta(delta, idx, h, w)
    a, b = dct.sparse_factors_f32(delta, idx, h, w)
    return dct.matmul(a.transpose(-1, -2), b, precision) * inverse_scale(h, w)


def _broadcast_marks(marks: torch.Tensor, batch: int) -> torch.Tensor:
    """(M, N) shared across the batch -> (B, M, N); (B, M, N) as is."""
    if marks.ndim == 2:
        return marks[None].expand(batch, *marks.shape)
    return marks


def _modulate(idx: torch.Tensor, original: torch.Tensor,
              marks: torch.Tensor, config: WriteConfig) -> torch.Tensor:
    """The new values of the ranked coefficients ``original`` at ``idx``."""
    return modulation.embed_marks(
        original, _broadcast_marks(marks, original.shape[0]),
        config.insertion.method, config.insertion.alpha,
        custom_insert=config.custom_insert, indices=idx)


def _modulated(rgb: torch.Tensor, marks: torch.Tensor, config: WriteConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fast prologue and the modulation: ``(idx, original, new)``."""
    with trace.span("ssw.forward"):
        idx, original = _rank_and_values_fast(
            rgb, marks.shape[-1], config.ordering, config.precision,
            config.custom_ordering, config.rank_version)
    return idx, original, _modulate(idx, original, marks, config)


def _embed_fast(rgb: torch.Tensor, marks: torch.Tensor, config: WriteConfig,
                quantize: bool = True) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Rank, modulate and add the sparse bf16 inverse: ``(marked, idx,
    original)``. A u8 image quantized to u8 takes kernel K4; float images
    and float output add the bf16 dY in f32 (the JAX package's XLA form)."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    idx, original, new_values = _modulated(rgb, marks, config)
    with trace.span("ssw.inverse"):
        delta = new_values - original
        if quantize and rgb.dtype == torch.uint8:
            return (embed_epilogue(rgb.contiguous(), delta.to(torch.float32),
                                   idx), idx, original)
        out = colorspace.add_luma_delta_f32(
            rgb, _sparse_idct_delta(delta, idx, h, w, Precision.DEFAULT))
    return (colorspace.f32_to_u8(out) if quantize else out), idx, original


def _with_luma(yiq: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """RGB from the base's YIQ with Y replaced by ``y``: the reference's
    Writer::result (src/algorithm.rs:361-374)."""
    return colorspace.yiq_to_rgb(
        torch.stack([y, yiq[..., 1], yiq[..., 2]], dim=-1))


def _embed_fast_full_inverse(rgb: torch.Tensor, marks: torch.Tensor,
                             config: WriteConfig,
                             quantize: bool) -> torch.Tensor:
    """``embed(sparse_idct=False)`` at the fast tiers (JAX
    ``pipeline.py:370-407``). It ranks through the fast prologue, since the
    fast Reader ranks there, then scatter-ADDS the same delta into the full
    transform of the YIQ image's Y at the tier (add, not set: the plane's
    value differs from the prologue's estimate, and detection recovers the
    delta against the estimate), and inverts the whole plane."""
    idx, original, new_values = _modulated(rgb, marks, config)
    yiq = colorspace.rgb_to_yiq(colorspace.to_f32(rgb))
    b, h, w = yiq.shape[:3]
    coeffs = dct.dct2_2d(yiq[..., 0], precision=config.precision)
    flat = coeffs.reshape(b, h * w).scatter_add(-1, idx,
                                                new_values - original)
    with trace.span("ssw.inverse"):
        y = dct.idct2_2d(flat.reshape(b, h, w), precision=config.precision)
        out = _with_luma(yiq, y)
    return colorspace.f32_to_u8(out) if quantize else out


def _embed_highest(rgb: torch.Tensor, marks: torch.Tensor,
                   config: WriteConfig, quantize: bool, sparse_idct: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference-exact embed: ``(marked, idx, original)``, the last two
    being the base's ranked indices and f32 coefficients there, exactly
    what a Reader re-derives from the same base."""
    with trace.span("ssw.forward"):
        coeffs = _forward(rgb, Precision.HIGHEST)
    b, h, w = coeffs.shape
    with trace.span("ssw.rank"):
        idx = ranking.top_indices(coeffs, marks.shape[-1], config.ordering,
                                  custom_metric=config.custom_ordering)
    flat = coeffs.reshape(b, h * w)
    original = torch.gather(flat, -1, idx)
    new_values = modulation.embed_marks(
        original, _broadcast_marks(marks, b), config.insertion.method,
        config.insertion.alpha, custom_insert=config.custom_insert,
        indices=idx)
    if sparse_idct:
        with trace.span("ssw.inverse"):
            delta = (new_values - original).to(torch.float32)
            if quantize and rgb.dtype == torch.uint8:
                # Kernel K10 in its u8 mode: neither dY nor an f32 RGB
                # reaches device memory.
                return highest_inverse(rgb, delta, idx), idx, original
            out = colorspace.add_luma_delta_f32(
                rgb, _sparse_idct_delta(delta, idx, h, w, Precision.HIGHEST))
    else:
        # The reference's Writer::result: the full inverse of the changed
        # plane, with the base's I and Q.
        yiq = colorspace.rgb_to_yiq(colorspace.to_f32(rgb))
        out = _with_luma(yiq, dct.idct2_2d(
            flat.scatter(-1, idx, new_values).reshape(b, h, w)))
    if quantize:
        out = colorspace.f32_to_u8(out)
    return out, idx, original


def _extract_fast_tail(base: torch.Tensor, derived: torch.Tensor,
                       idx: torch.Tensor, base_vals: torch.Tensor,
                       config: ReadConfig,
                       sparse_second: bool = True) -> torch.Tensor:
    """Delta-exact read given the base's ranked indices and values, at
    DEFAULT for both fast tiers, as in the JAX package.

    The derived image is never transformed on its own: the first pass runs
    on ``luma(derived) - luma(base)`` (from the exact integer difference for
    u8 pairs; otherwise the difference of the f32 lumas and a plain bf16
    pass), and the second pass only at the n indices (in full, then
    gathered, with ``sparse_second=False``). A u8 pair's sparse read is one
    call of kernel K5 (``read_tail``), which runs the first pass only at
    the ranked rows; with ``sparse_second=False`` the first pass is K1's
    pair mode over the whole plane. A ``custom_extract``
    sees ``(idx, base_vals, base_vals + num)``, as in the JAX package: the
    derived values rebuilt from the base's estimates and the delta.
    """
    if base.shape != derived.shape:
        raise ValueError(f"base {tuple(base.shape)} and derived "
                         f"{tuple(derived.shape)} differ in shape")
    h, w = base.shape[-3], base.shape[-2]
    ax = dct.shorter_axis(h, w)
    u8 = base.dtype == torch.uint8 and derived.dtype == torch.uint8
    with trace.span("ssw.read"):
        if u8 and sparse_second:
            num = read_tail(derived.contiguous(), base.contiguous(), idx)
        else:
            if u8:
                td = luma_pass(derived.contiguous(), base.contiguous())
            else:
                td = dct.dct2_pass(colorspace.luma_diff(base, derived).to(
                    torch.bfloat16), axis=ax, precision=Precision.DEFAULT,
                    out_dtype=torch.bfloat16)
            if sparse_second:
                num = dct.dct2_dot_at(td, idx, contracted_axis=ax,
                                      precision=Precision.DEFAULT)
            else:
                other = -1 if ax == -2 else -2
                dplane = dct.dct2_pass(td, axis=other,
                                       precision=Precision.DEFAULT)
                num = torch.gather(dplane.reshape(*dplane.shape[:-2], h * w),
                                   -1, idx)
        if config.custom_extract is not None:
            return config.custom_extract(idx, base_vals, base_vals + num)
        method, alpha = config.extraction.method, config.extraction.alpha
        if method == Method.OPTION1:  # (d - b) / alpha
            return num / alpha
        if method == Method.OPTION2:  # (d - b) / (b * alpha)
            return num / (base_vals * alpha)
        if method == Method.OPTION3:  # ln(d / b) / alpha, as log1p(num / b)
            return torch.log1p(num / base_vals) / alpha
    raise ValueError(f"unknown method {method}")


def _read_config(config: WriteConfig) -> ReadConfig:
    return ReadConfig(extraction=config.insertion, ordering=config.ordering,
                      precision=config.precision,
                      custom_ordering=config.custom_ordering,
                      rank_version=config.rank_version)


def _extract_values(config: ReadConfig, idx: torch.Tensor,
                    base_vals: torch.Tensor,
                    derived_vals: torch.Tensor) -> torch.Tensor:
    if config.custom_extract is not None:
        return config.custom_extract(idx, base_vals, derived_vals)
    return modulation.extract_values(config.extraction.method,
                                     config.extraction.alpha, base_vals,
                                     derived_vals)


@trace.entry
def embed(rgb: torch.Tensor, marks: torch.Tensor,
          config: WriteConfig = WriteConfig(), quantize: bool = True,
          sparse_idct: bool = True) -> torch.Tensor:
    """Embed watermark(s) into images of ``rgb``'s shape.

    ``rgb``: u8, or float RGB in [0, 1]. ``marks``: (N,) one mark, (M, N)
    M marks shared across the batch, or (B, M, N) per image; several marks
    add their deltas (reference: src/algorithm.rs:382-410). ``quantize``:
    u8 output (the reference's ``into_rgb8``), else f32. ``sparse_idct``:
    invert only the n changed coefficients (the default); False runs the
    reference's full inverse transform of the changed plane (at the fast
    tiers after ranking through the fast prologue, which the Reader uses).
    """
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    if marks.ndim == 1:
        marks = marks[None]
    if config.precision is Precision.HIGHEST:
        marked, _, _ = _embed_highest(rgb, marks, config, quantize,
                                      sparse_idct)
    elif sparse_idct:
        marked, _, _ = _embed_fast(rgb, marks, config, quantize)
    else:
        marked = _embed_fast_full_inverse(rgb, marks, config, quantize)
    return marked[0] if single else marked


@trace.entry
def embed_verified(rgb: torch.Tensor, marks: torch.Tensor,
                   config: WriteConfig = WriteConfig(),
                   quantize: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed, then extract from the (quantized) output with the base's
    ranking: ``(marked, extracted)``, what :func:`extract` (HIGHEST) or
    :func:`rank_base` + :func:`extract_ranked` (fast tiers) would read from
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
        derived_vals = _read_highest(marked, idx)
        ext = _extract_values(rconfig, idx, base_vals, derived_vals)
    else:
        marked, idx, original = _embed_fast(rgb, marks, config, quantize)
        ext = _extract_fast_tail(rgb, marked, idx, original, rconfig)
    if single:
        return marked[0], ext[0]
    return marked, ext


@trace.entry
def prepare_base(rgb: torch.Tensor, n: int, config: ReadConfig = ReadConfig()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The base image's flat f32 coefficients at the tier and its exact
    top-n indices: ``(flat, idx)``, the HIGHEST Reader's cache (reference
    ``Reader::base``, src/algorithm.rs:462-498). The JAX package allows it
    at every tier; at the fast tiers prefer :func:`rank_base`."""
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


@trace.entry
def prepare_derived(rgb: torch.Tensor, config: ReadConfig = ReadConfig()
                    ) -> torch.Tensor:
    """A derived image's flat f32 coefficients at the tier (reference
    ``Reader::derived``, src/algorithm.rs:469-480)."""
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    flat = _forward(rgb, config.precision).reshape(rgb.shape[0], -1)
    return flat[0] if single else flat


@trace.entry
def extract_prepared(base_flat: torch.Tensor, idx: torch.Tensor,
                     derived_flat: torch.Tensor,
                     config: ReadConfig = ReadConfig()) -> torch.Tensor:
    """The mark from prepared coefficients: both gathered at ``idx``, then
    the inverse equation (reference ``Reader::extract_watermark``,
    src/algorithm.rs:543-562). Meaningful at HIGHEST, where both planes
    are f32-exact."""
    with trace.span("ssw.read"):
        return _extract_values(config, idx, torch.gather(base_flat, -1, idx),
                               torch.gather(derived_flat, -1, idx))


@trace.entry
def rank_base(rgb: torch.Tensor, n: int, config: ReadConfig = ReadConfig()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The base image's ranked ``(indices, values)`` through the fast
    prologue, the fast tiers' Reader cache (reference ``Reader::base``,
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
    f32 transform at HIGHEST, the bf16 two-pass plane at DEFAULT and HIGH."""
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    if precision is Precision.HIGHEST:
        out = _forward(rgb, precision)
    else:
        ax = dct.shorter_axis(rgb.shape[-3], rgb.shape[-2])
        out = _second_pass(_half_pass(rgb, precision), ax).to(torch.float32)
    return out[0] if single else out


@trace.entry
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
    tiers' delta-exact read."""
    if config.precision is not Precision.HIGHEST:
        with trace.span("ssw.forward"):
            idx, base_vals = _rank_and_values_fast(
                base, n, config.ordering, config.precision,
                config.custom_ordering, config.rank_version)
            return _extract_fast_tail(base, derived, idx, base_vals, config,
                                      sparse_second)
    coeffs = _forward(base, config.precision)
    idx = ranking.top_indices(coeffs, n, config.ordering,
                              custom_metric=config.custom_ordering)
    base_vals = torch.gather(coeffs.reshape(coeffs.shape[0], -1), -1, idx)
    derived_vals = _read_highest(derived, idx)
    return _extract_values(config, idx, base_vals, derived_vals)


@trace.entry
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
