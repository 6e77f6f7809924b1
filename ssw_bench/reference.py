"""The plain reference of the watermarking tiers, in PyTorch, float64.

It is written from the algorithm's statement (Cox et al.'s spread-spectrum
watermark as the reference crate computes it, github.com/iwanders/
spread_spectrum_watermarking, src/algorithm.rs and src/dct2d.rs) and from
what each precision tier states, not from the program under test: it
imports only torch, and it takes nothing that the program made.

Every sum is taken in float64, which holds the products of the tiers'
operands exactly and adds a few thousand of them with no error that could
move a rounding of the tier. Where a tier rounds, the reference rounds too,
to the tier's significant bits (:func:`round_bits`):

- ``DEFAULT`` (bf16, 8 significant bits): the luma, the bases, the first
  pass and the rank plane; the inverse's two factors; the read's luma
  difference, its first pass and the basis of its dots.
- ``HIGHEST`` (f32, 24 significant bits): the luma, the bases and the
  result of each pass.

The control of a tier is the same code one precision lower
(:data:`CONTROL_BITS`): fp8 e4m3's 4 significant bits for bf16, TF32's 11
for f32. Both keep float32's exponent range (per-tensor scaling), so only
the precision changes.

Shapes: ``rgb`` (B, H, W, 3) u8; ``marks`` (B, n); flat indices (B, n)
int64 into the row-major (H, W) plane.
"""

from __future__ import annotations

import torch

F64 = torch.float64
#: Significant bits of each tier's roundings.
TIER_BITS = {"default": 8, "highest": 24}
#: The control's: the nearest precision below the tier's.
CONTROL_BITS = {"default": 4, "highest": 11}


def round_bits(x: torch.Tensor, bits: int | None) -> torch.Tensor:
    """``x`` rounded to ``bits`` significant bits, to nearest, ties to
    even, with float64's exponent range; None leaves it as it is."""
    if bits is None:
        return x
    m, e = torch.frexp(x)
    scale = float(2 ** bits)
    return torch.ldexp(torch.round(m * scale) / scale, e)


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """Y of YIQ (colorsys's 0.30, 0.59, 0.11) of u8 RGB scaled to [0, 1]."""
    x = rgb.to(F64)
    return (0.30 * x[..., 0] + 0.59 * x[..., 1] + 0.11 * x[..., 2]) / 255.0


def luma_diff(base: torch.Tensor, derived: torch.Tensor) -> torch.Tensor:
    """Y of ``derived - base``, exact: ``(30 dR + 59 dG + 11 dB) / 25500``."""
    d = derived.to(F64) - base.to(F64)
    return (30.0 * d[..., 0] + 59.0 * d[..., 1] + 11.0 * d[..., 2]) / 25500.0


def dct_basis(n: int, device) -> torch.Tensor:
    """DCT-II with scipy's scaling: ``C[k, m] = 2 cos(pi k (2m + 1) / 2n)``
    (src/dct2d.rs: rustdct's output times 2)."""
    k = torch.arange(n, dtype=F64, device=device)[:, None]
    m = torch.arange(n, dtype=F64, device=device)[None, :]
    return 2.0 * torch.cos(torch.pi * k * (2.0 * m + 1.0) / (2.0 * n))


def idct_basis(n: int, device) -> torch.Tensor:
    """DCT-III with the crate's halving: ``D[k, 0] = 1/4``, ``D[k, m] =
    cos(pi m (2k + 1) / 2n) / 2``; the 2-D inverse is ``4 / (H W) D_h X
    D_w^T`` (src/dct2d.rs)."""
    k = torch.arange(n, dtype=F64, device=device)[:, None]
    m = torch.arange(n, dtype=F64, device=device)[None, :]
    d = 0.5 * torch.cos(torch.pi * m * (2.0 * k + 1.0) / (2.0 * n))
    d[:, 0] = 0.25
    return d


def _out_bits(tier: str, bits: int) -> int:
    """What a pass's result rounds to: bf16's points take the operands'
    precision (the control's fp8 too); f32's stay f32."""
    return bits if tier == "default" else TIER_BITS["highest"]


def forward(rgb: torch.Tensor, tier: str, bits: int) -> torch.Tensor:
    """The (B, H, W) plane the tier ranks on.

    ``default``: the bf16 luma, one pass over the shorter axis rounded to
    bf16, the other pass rounded to bf16 (the rank plane). ``highest``: the
    f32 luma and the 2-D transform ``(C_h Y) C_w^T``, each pass rounded to
    f32. ``bits`` rounds the operands of every product (the tier's own, or
    the control's)."""
    h, w = rgb.shape[1], rgb.shape[2]
    out = _out_bits(tier, bits)
    y = luma(rgb)
    if tier == "highest":
        y = round_bits(y, TIER_BITS["highest"])
    y = round_bits(y, bits)
    ch = round_bits(dct_basis(h, rgb.device), bits)
    cw = round_bits(dct_basis(w, rgb.device), bits)
    if tier == "highest" or h <= w:
        t = round_bits(round_bits(ch @ y, out), bits)
        return round_bits(t @ cw.T, out)
    t = round_bits(round_bits(y @ cw.T, out), bits)
    return round_bits(ch @ t, out)


def _bf16_key_parts(plane: torch.Tensor):
    """The 16 bits of each value of a plane that bf16 holds exactly:
    the magnitude with its last bit cleared, and the sign."""
    v = plane.to(torch.float32).to(torch.bfloat16)
    bits = v.view(torch.int16).to(torch.int64) & 0xFFFF
    return (bits & 0x7FFE), (bits >> 15) & 1


def _top(key: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """Positions of the n largest ``key`` (int64, below 2^31) in the order
    (key desc, ``pos`` asc)."""
    comp = key * (1 << 32) + ((1 << 31) - 1 - pos)
    return torch.topk(comp, n, dim=-1, sorted=True).indices


def rank(plane: torch.Tensor, tier: str, n: int):
    """``(idx, vals)``: the n ranked flat indices and the values the tier
    takes for them (:func:`values_at`), DC never ahead of another
    coefficient.

    ``default`` (rank generation 2): keys are the bf16 magnitude with its
    last bit replaced by the sign; the n largest keys, ties by index; then
    ordered by the magnitude bits, ties by index. ``highest`` (Energy):
    ``v^2`` descending, ties by index."""
    b = plane.shape[0]
    flat = plane.reshape(b, -1)
    pos = torch.arange(flat.shape[1], device=plane.device)
    if tier == "highest":
        # v^2's order is |v|'s; float32 bits of |v| order like |v|.
        key = flat.abs().to(torch.float32).view(torch.int32).to(torch.int64)
        key[:, 0] = -1
        idx = _top(key, pos, n)
        return idx, values_at(plane, idx, tier)
    mag, sign = _bf16_key_parts(flat)
    key = mag | sign
    key[:, 0] = -1
    sel = _top(key, pos, n)
    kmag = torch.gather(mag, 1, sel)
    kmag = torch.where(sel == 0, -1, kmag)
    idx = torch.gather(sel, 1, _top(kmag, sel, n))
    return idx, values_at(plane, idx, tier)


def values_at(plane: torch.Tensor, idx: torch.Tensor, tier: str
              ) -> torch.Tensor:
    """The values (B, n) the tier takes for the coefficients at ``idx``:
    ``highest`` the coefficient; ``default`` the signed magnitude its key
    keeps (bf16 with the last bit cleared), 0 at DC."""
    flat = plane.reshape(plane.shape[0], -1)
    if tier == "highest":
        return torch.gather(flat, 1, idx)
    mag, sign = _bf16_key_parts(torch.gather(flat, 1, idx))
    mag_v = mag.to(torch.int16).view(torch.bfloat16).to(F64)
    vals = torch.where(sign == 1, -mag_v, mag_v)
    return torch.where(idx == 0, 0.0, vals)


def modulate(vals: torch.Tensor, marks: torch.Tensor,
             alpha: float) -> torch.Tensor:
    """The change of each ranked value under Option2, ``x' = x (1 + alpha
    w)``: ``x' - x``."""
    return vals * (1.0 + alpha * marks.to(F64)) - vals


def inverse(delta: torch.Tensor, idx: torch.Tensor, h: int, w: int,
            tier: str, bits: int) -> torch.Tensor:
    """dY (B, H, W) of the changes ``delta`` at ``idx``: ``4/(H W) D_h[:,
    r] diag(delta) D_w[:, c]^T``. ``default`` rounds its two factors (the
    scale and delta in the first) to ``bits``; ``highest`` rounds the
    bases and ``delta`` to ``bits``."""
    r, c = idx // w, idx % w
    dh = idct_basis(h, delta.device)
    dw = idct_basis(w, delta.device)
    scale = 4.0 / (h * w)
    a = dh.T[r]                                   # (B, n, H)
    bmat = round_bits(dw.T[c], bits)              # (B, n, W)
    if tier == "default":
        a = round_bits(a * (delta * scale)[..., None], bits)
        return a.transpose(1, 2) @ bmat
    a = round_bits(a, bits) * round_bits(delta, bits)[..., None]
    return (a.transpose(1, 2) @ bmat) * scale


def apply(rgb: torch.Tensor, dy: torch.Tensor, tier: str) -> torch.Tensor:
    """The marked u8 image: dY added to every channel (Y's column of the
    YIQ inverse is all ones), rounded half up and clamped.
    ``default`` adds ``255 dY`` to the bytes; ``highest`` adds ``dY`` to
    the bytes over 255 and clamps to [0, 1] before scaling back."""
    x = rgb.to(F64)
    if tier == "default":
        out = torch.floor(x + 255.0 * dy[..., None] + 0.5).clamp(0, 255)
    else:
        out = torch.floor((x / 255.0 + dy[..., None]).clamp(0, 1) * 255.0
                          + 0.5)
    return out.to(torch.uint8)


def _coeffs_at(y: torch.Tensor, idx: torch.Tensor, tier: str,
               bits: int) -> torch.Tensor:
    """Coefficients (B, n) of the plane ``y`` (B, H, W) at ``idx``: the
    pass over H, its result rounded as the tier rounds it, then the dots
    with the W basis at the columns; operands rounded to ``bits``."""
    h, w = y.shape[1], y.shape[2]
    r, c = idx // w, idx % w
    ch = round_bits(dct_basis(h, y.device), bits)
    cw = round_bits(dct_basis(w, y.device), bits)
    t = round_bits(round_bits(ch @ round_bits(y, bits),
                              _out_bits(tier, bits)), bits)
    rows = torch.gather(t, 1, r[..., None].expand(-1, -1, w))  # (B, n, W)
    return (rows * cw[c]).sum(-1)


def read(base: torch.Tensor, derived: torch.Tensor, idx: torch.Tensor,
         vals: torch.Tensor, alpha: float, tier: str, bits: int
         ) -> torch.Tensor:
    """The extracted mark (B, n) of ``derived`` against ``base`` at the
    ranked ``idx`` with the base's ``vals``, Option2's inverse ``(x* - x)
    / (alpha x)``, for landscape images (H <= W).

    ``default`` reads the change only: the exact luma difference rounded to
    bf16, its pass over H rounded to bf16, dots with the bf16 basis; ``x*
    - x`` is that coefficient. ``highest`` transforms the derived image's
    f32 luma at ``idx`` (each pass's result in f32) and subtracts
    ``vals``."""
    if base.shape[1] > base.shape[2]:
        raise ValueError("the reference reads landscape images only")
    if tier == "default":
        num = _coeffs_at(luma_diff(base, derived), idx, tier, bits)
        return num / (vals * alpha)
    y = round_bits(luma(derived), TIER_BITS["highest"])
    got = round_bits(_coeffs_at(y, idx, tier, bits), TIER_BITS["highest"])
    return (got - vals) / (vals * alpha)


def similarity(ext: torch.Tensor, marks: torch.Tensor) -> torch.Tensor:
    """Cox et al.'s ``X* . X / sqrt(X* . X*)``: (B, n) x (K, n) -> (B, K)."""
    e = ext.to(F64)
    return (e @ marks.to(F64).T) / torch.sqrt((e * e).sum(-1, keepdim=True))


def embed(rgb: torch.Tensor, marks: torch.Tensor, tier: str, n: int,
          alpha: float, bits: int):
    """The whole marking step: ``(marked, idx, vals)``."""
    h, w = rgb.shape[1], rgb.shape[2]
    idx, vals = rank(forward(rgb, tier, bits), tier, n)
    dy = inverse(modulate(vals, marks, alpha), idx, h, w, tier, bits)
    return apply(rgb, dy, tier), idx, vals
