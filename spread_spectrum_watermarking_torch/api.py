"""Reference-shaped object API: Writer / Reader / Tester, in PyTorch.

Port of the JAX package's ``api.py``: thin host-side wrappers over the
functional pipelines in :mod:`.models.pipeline`, with the reference crate's
surface (``wm::Writer``/``wm::Reader``/``wm::Tester``, reference
src/lib.rs:81-85, src/algorithm.rs:286-715). Like the JAX package's, they
take numpy arrays or PIL images and return numpy. The work runs on the
device named by the keyword ``device``: the CUDA card unless the caller
passes ``device="cpu"``. It is never chosen by probing, and there is no
fallback: without a card the default fails with torch's own error.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import trace
from .config import Precision, ReadConfig, WriteConfig
from .marks import as_marks
from .models import pipeline
from .ops import ranking


def _as_rgb_array(image) -> np.ndarray:
    """Accept a PIL image or array; return (H, W, 3) uint8 or float32."""
    if hasattr(image, "convert"):  # PIL
        image = np.asarray(image.convert("RGB"))
    arr = np.asarray(image)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) RGB image, got {arr.shape}")
    return arr


def _numpy(t: torch.Tensor) -> np.ndarray:
    """The device's result on the host: the span ``ssw.d2h``."""
    with trace.span("ssw.d2h"):
        trace.count("d2h_bytes", t.nbytes)
        return t.detach().cpu().numpy()


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on the device: the span ``ssw.h2d``."""
    with trace.span("ssw.h2d"):
        trace.count("h2d_bytes", arr.nbytes)
        return torch.tensor(arr, device=device)  # a copy: arr may be read-only


class Writer:
    """Embeds watermarks into one image (reference: src/algorithm.rs:286-433).

    The transform, ranking and embedding all run at :meth:`mark` time; the
    :meth:`coefficients`/:meth:`indices` accessors run the forward
    transform on demand (``Writer::coefficient_image``,
    src/algorithm.rs:319-321).
    """

    def __init__(self, image, config: WriteConfig = WriteConfig(), *,
                 device="cuda"):
        self._rgb = _as_rgb_array(image)
        self._config = config
        self._device = torch.device(device)
        self._coeffs: Optional[np.ndarray] = None

    def _image(self) -> torch.Tensor:
        return _tensor(self._rgb, self._device)

    def coefficients(self) -> np.ndarray:
        """Y-channel DCT coefficients, shape (H, W): the plane the active
        tier ranks on (exact f32 at HIGHEST, the bf16 two-pass plane at
        DEFAULT)."""
        if self._coeffs is None:
            self._coeffs = _numpy(pipeline.rank_plane(
                self._image(), self._config.precision))
        return self._coeffs

    def indices(self, n: int) -> np.ndarray:
        """Rank-ordered flat indices of the n strongest coefficients: the
        indices :meth:`mark` embeds at, at every tier."""
        c = self._config
        if c.precision is not Precision.HIGHEST:
            rcfg = ReadConfig(ordering=c.ordering, precision=c.precision,
                              custom_ordering=c.custom_ordering,
                              rank_version=c.rank_version)
            idx, _ = pipeline.rank_base(self._image(), n, rcfg)
            return _numpy(idx)
        coeffs = _tensor(self.coefficients(), self._device)
        return _numpy(ranking.top_indices(coeffs, n, c.ordering,
                                          custom_metric=c.custom_ordering))

    def update_indices(self, ordering, custom_metric=None) -> None:
        """Re-rank with another ordering (reference ``Writer::update_indices``,
        src/algorithm.rs:324-327): later :meth:`indices`/:meth:`mark` calls
        use it against the same image."""
        self._config = dataclasses.replace(
            self._config, ordering=ordering, custom_ordering=custom_metric)

    def mark(self, marks, quantize: bool = True) -> np.ndarray:
        """Embed mark(s), array-like (N,) or (M, N); returns the (H, W, 3)
        image, uint8 if ``quantize`` else float32."""
        m = _tensor(as_marks(marks), self._device)
        return _numpy(pipeline.embed(self._image(), m, self._config,
                                     quantize=quantize))


class ReaderDerived:
    """Derived-image reader: coefficients only (reference:
    src/algorithm.rs:448-456)."""

    def __init__(self, image, config: ReadConfig = ReadConfig(), *,
                 device="cuda"):
        self._rgb = _as_rgb_array(image)
        self._config = config
        self._device = torch.device(device)
        self._flat: Optional[np.ndarray] = None

    def coefficients(self) -> np.ndarray:
        if self._flat is None:
            self._flat = _numpy(pipeline.rank_plane(
                _tensor(self._rgb, self._device),
                self._config.precision)).reshape(-1)
        return self._flat


class Reader:
    """Base-image reader (reference: src/algorithm.rs:441-562)."""

    def __init__(self, image, config: ReadConfig = ReadConfig(), *,
                 device="cuda"):
        self._rgb = _as_rgb_array(image)
        self._config = config
        self._device = torch.device(device)
        self._cache = {}  # n -> (flat, idx) at HIGHEST / (idx, vals) fast
        self._flat: Optional[np.ndarray] = None  # coefficients() memo

    @staticmethod
    def base(image, config: ReadConfig = ReadConfig(), *,
             device="cuda") -> "Reader":
        return Reader(image, config, device=device)

    @staticmethod
    def derived(image, config: ReadConfig = ReadConfig(), *,
                device="cuda") -> ReaderDerived:
        return ReaderDerived(image, config, device=device)

    @property
    def _fast(self) -> bool:
        return self._config.precision is not Precision.HIGHEST

    def _image(self) -> torch.Tensor:
        return _tensor(self._rgb, self._device)

    def _prepared(self, n: int):
        """Cached base-side work, keyed on n (the reference CLI's extraction
        cache, examples/main.rs:369-412): at HIGHEST the full coefficient
        plane and the indices (``pipeline.prepare_base``); at DEFAULT the
        indices and base values of the delta-exact prologue
        (``pipeline.rank_base``)."""
        if n not in self._cache:
            prepare = pipeline.rank_base if self._fast else pipeline.prepare_base
            self._cache[n] = prepare(self._image(), n, self._config)
        return self._cache[n]

    def coefficients(self) -> np.ndarray:
        """Flat DCT coefficient plane of the base image (reference accessor,
        src/algorithm.rs:502-504): the plane the active tier ranks on."""
        if not self._fast:
            for flat, _ in self._cache.values():
                return _numpy(flat)
        if self._flat is None:
            self._flat = _numpy(pipeline.rank_plane(
                self._image(), self._config.precision)).reshape(-1)
        return self._flat

    def indices(self, n: int) -> np.ndarray:
        pair = self._prepared(n)
        return _numpy(pair[0] if self._fast else pair[1])

    def extract(self, derived: ReaderDerived, n: int) -> np.ndarray:
        """Extract a length-n watermark from a derived reader.

        Raises ValueError on the reference's panic conditions
        (src/algorithm.rs:550-555).
        """
        return self._extract_stack(derived._rgb[None], n)[0]

    def _extract_stack(self, images, n: int) -> np.ndarray:
        """:meth:`extract` of each image of a (B, H, W, 3) stack, in one
        call -> (B, n): the CLI's ``detect`` reads a chunk of derived
        images so, with the base's work cached as for one."""
        stack = np.asarray(images)
        if stack.shape[1:] != self._rgb.shape:
            raise ValueError(
                "Derived coefficient length not equal to base coefficient length.")
        h, w = self._rgb.shape[:2]
        if n >= h * w:
            raise ValueError(
                "Desired extraction length exceeds available coefficients.")
        b = stack.shape[0]
        derived = _tensor(stack, self._device)
        if self._fast:
            idx, base_vals = self._prepared(n)
            return _numpy(pipeline.extract_ranked(
                self._image().expand(b, -1, -1, -1), derived,
                idx.expand(b, -1), base_vals.expand(b, -1), self._config))
        flat, idx = self._prepared(n)
        return _numpy(pipeline.extract_prepared(
            flat.expand(b, -1), idx.expand(b, -1),
            pipeline.prepare_derived(derived, self._config), self._config))


class Similarity:
    """Result wrapper (reference: src/algorithm.rs:668-680)."""

    def __init__(self, similarity: float):
        self.similarity = float(similarity)

    def exceeds_sigma(self, n_sigma: float) -> bool:
        return self.similarity > n_sigma

    def __repr__(self):
        return f"Similarity {{ similarity: {self.similarity} }}"


class Tester:
    """Similarity tester (reference: src/algorithm.rs:683-715)."""

    def __init__(self, extracted_watermark, *, device="cuda"):
        self._extracted = np.asarray(extracted_watermark, dtype=np.float32)
        self._device = torch.device(device)

    def _sims(self, candidates: np.ndarray) -> np.ndarray:
        ext = _tensor(self._extracted[None], self._device)
        cand = _tensor(candidates, self._device)
        return _numpy(pipeline.similarity(ext, cand))[0]

    def similarity(self, comparison_watermark) -> Similarity:
        cand = np.asarray(comparison_watermark, dtype=np.float32)
        if cand.shape != self._extracted.shape:
            raise ValueError("extracted and comparison watermark lengths differ")
        return Similarity(self._sims(cand[None])[0])

    def similarities(self, candidates) -> np.ndarray:
        """Batched sweep: test K candidate marks at once -> (K,) sims."""
        return self._sims(as_marks(candidates))
