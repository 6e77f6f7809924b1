"""Images with natural statistics, made on the device from a seed.

A copy, in torch, of the port's ``bench.natural_corpus_chunk`` with no
asset: each image is a crop of a mosaic of a 1/f-spectrum texture (the
standard model of natural-image statistics), with flips and a gain and
bias jitter. The texture, the crops and the jitter are drawn from one
``torch.Generator`` on the device, in a few large calls, so that set-up
stays short and never touches the host's RNG. It is the benchmark's own:
a change to the program cannot move it.
"""

from __future__ import annotations

import torch

#: Side of the square texture that the mosaic tiles (the port's harness's).
TEXTURE = 512
#: Exponent of the texture's amplitude spectrum, ``1 / f**EXPONENT``.
EXPONENT = 1.2


def texture(gen: torch.Generator, device, side: int = TEXTURE
            ) -> torch.Tensor:
    """(side, side, 3) u8: each channel the inverse FFT of a ``1/f^1.2``
    amplitude spectrum with uniform random phases, scaled to [0, 255]."""
    fy = torch.fft.fftfreq(side, device=device, dtype=torch.float64)[:, None]
    fx = torch.fft.rfftfreq(side, device=device, dtype=torch.float64)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    phase = torch.rand((3, side, fx.shape[1]), generator=gen, device=device,
                       dtype=torch.float64) * (2.0 * torch.pi)
    spec = f.pow(-EXPONENT) * torch.exp(1j * phase)
    img = torch.fft.irfft2(spec, s=(side, side))
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    img = (img - lo) / (hi - lo + 1e-9)
    return (img * 255.0).to(torch.uint8).permute(1, 2, 0).contiguous()


def crops(gen: torch.Generator, src: torch.Tensor, count: int, h: int,
          w: int) -> torch.Tensor:
    """(count, h, w, 3) u8: distinct crops of the mosaic that tiles ``src``
    past (h + 256, w + 256), each flipped at random along each axis, then
    ``clip(x * gain + bias)`` with gain in [0.8, 1.2) and an integer bias
    in [-16, 16]."""
    device = src.device
    sh, sw = src.shape[:2]
    reps_h, reps_w = -(-(h + 256) // sh), -(-(w + 256) // sw)
    canvas = src.repeat(reps_h, reps_w, 1)
    oy = torch.randint(0, canvas.shape[0] - h + 1, (count,), generator=gen,
                       device=device)
    ox = torch.randint(0, canvas.shape[1] - w + 1, (count,), generator=gen,
                       device=device)
    flips = torch.randint(0, 2, (count, 2), generator=gen, device=device)
    gain = 0.8 + 0.4 * torch.rand(count, generator=gen, device=device)
    bias = torch.randint(-16, 17, (count,), generator=gen,
                         device=device).to(torch.float32)
    # Row and column indices of every crop, flips folded in: two gathers.
    ry = torch.arange(h, device=device)
    rx = torch.arange(w, device=device)
    ry = torch.where(flips[:, 1:2] == 1, h - 1 - ry, ry) + oy[:, None]
    rx = torch.where(flips[:, 0:1] == 1, w - 1 - rx, rx) + ox[:, None]
    rows = canvas[ry]                                   # (count, h, Wc, 3)
    img = torch.gather(rows, 2, rx[:, None, :, None].expand(count, h, w, 3))
    x = img.to(torch.float32) * gain[:, None, None, None] \
        + bias[:, None, None, None]
    return x.clamp(0.0, 255.0).to(torch.uint8)


def images(gen: torch.Generator, count: int, h: int, w: int, device,
           per_texture: int) -> torch.Tensor:
    """(count, h, w, 3) u8, a new texture for each ``per_texture`` images
    (the port's harness draws one texture a chunk)."""
    out = torch.empty((count, h, w, 3), dtype=torch.uint8, device=device)
    for start in range(0, count, per_texture):
        k = min(per_texture, count - start)
        out[start:start + k] = crops(gen, texture(gen, device), k, h, w)
    return out
