"""Bit-compatible reimplementation of the reference's seeded mark generator.

The reference's test fixtures are N(0,1) sequences drawn from
``ChaCha8Rng::seed_from_u64(seed)`` through ``rand_distr::StandardNormal``
(reference: tests/util.rs:6-13). Reproducing those exact f32 sequences lets
the parity suite check our pipeline against the reference's *golden artifacts*
(tests/watermarked_with_1.png embeds the seed-1 mark; the attack tests use
seed 2) without running any Rust.

Components reproduced:
  - ``rand_core``'s ``SeedableRng::seed_from_u64`` (PCG32-style expansion of a
    u64 into the 32-byte ChaCha key).
  - ``rand_chacha``'s ChaCha8 (djb variant: 64-bit block counter in words
    12-13, 64-bit stream id = 0 in words 14-15; 8 rounds), with the
    ``BlockRng`` u64 read order (lo = word i, hi = word i+1).
  - ``rand_distr``'s 256-layer ziggurat StandardNormal for f64 (f32 samples
    are f64 casts), including the table layout and the exact bit-to-float
    conversions (top 52 bits -> [2,4) - 3 for u; low 8 bits -> layer index).

The ziggurat tables are regenerated at import with the same recurrence and
constants as rand's generator script (ZIG_NORM_R = 3.654152885361008796,
area 0.00492867323399); end-to-end correctness is pinned by the golden-image
parity test (a wrong sequence yields ~0 sigma instead of ~31).

Performance note: this is a host-side fixture/compat tool; bulk marks come
from ``torch.Generator`` (marks.py). A copy of the JAX package's module,
with its dispatch: :func:`generate_fixed_normal_sequence` takes the C++
build of ``native/ssw_native.cpp`` (:mod:`._native`, built at its first
call where ``g++`` and ``Python.h`` exist), and the pure Python below is
its plain version, bit-equal and slower.
"""

from __future__ import annotations

import math
import struct
from typing import List

import numpy as np

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

# --------------------------------------------------------------------------
# rand_core: SeedableRng::seed_from_u64 (PCG-based seed expansion)
# --------------------------------------------------------------------------

_PCG_MUL = 6364136223846793005
_PCG_INC = 11634580027462260723


def seed_from_u64(seed: int, n_bytes: int = 32) -> bytes:
    """Expand a u64 into an RNG seed exactly like rand_core 0.6."""
    state = seed & _MASK64
    out = bytearray()
    for _ in range(n_bytes // 4):
        state = (state * _PCG_MUL + _PCG_INC) & _MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & _MASK32
        rot = (state >> 59) & 31
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _MASK32
        out += struct.pack("<I", x)
    return bytes(out)


# --------------------------------------------------------------------------
# ChaCha8 core (djb variant, as implemented by rand_chacha)
# --------------------------------------------------------------------------


def _rotl32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & _MASK32


def _chacha_block(key_words: List[int], counter: int, nonce_words: List[int],
                  rounds: int) -> List[int]:
    """One 64-byte ChaCha block -> 16 output u32 words."""
    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
             *key_words,
             counter & _MASK32, (counter >> 32) & _MASK32,
             nonce_words[0], nonce_words[1]]
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    return [(x[i] + state[i]) & _MASK32 for i in range(16)]


class ChaChaRng:
    """ChaCha keystream exposed with rand_core's u64 read order."""

    def __init__(self, seed_bytes: bytes, rounds: int = 8):
        assert len(seed_bytes) == 32
        self._key = list(struct.unpack("<8I", seed_bytes))
        self._nonce = [0, 0]
        self._rounds = rounds
        self._counter = 0
        self._buf: List[int] = []  # u32 words
        self._index = 0

    @classmethod
    def seed_from_u64(cls, seed: int, rounds: int = 8) -> "ChaChaRng":
        return cls(seed_from_u64(seed), rounds)

    def _refill(self):
        # BlockRng refills 4 blocks (256 bytes) at a time; block order is
        # sequential counters, words in natural order.
        words: List[int] = []
        for i in range(4):
            words += _chacha_block(self._key, self._counter + i, self._nonce,
                                   self._rounds)
        self._counter += 4
        self._buf = words
        self._index = 0

    def next_u32(self) -> int:
        if self._index >= len(self._buf):
            self._refill()
        v = self._buf[self._index]
        self._index += 1
        return v

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return (hi << 32) | lo


# --------------------------------------------------------------------------
# rand_distr StandardNormal: 256-layer ziggurat
# --------------------------------------------------------------------------

ZIG_NORM_R = 3.654152885361008796
_ZIG_NORM_AREA = 0.00492867323399  # per-strip area from rand's table generator


def _build_norm_tables():
    f = lambda x: math.exp(-x * x / 2.0)
    f_inv = lambda y: math.sqrt(-2.0 * math.log(y))
    n = 256
    x = [0.0] * (n + 1)
    x[0] = _ZIG_NORM_AREA / f(ZIG_NORM_R)
    x[1] = ZIG_NORM_R
    for i in range(1, n - 1):
        x[i + 1] = f_inv(_ZIG_NORM_AREA / x[i] + f(x[i]))
    x[n] = 0.0
    ftab = [f(v) for v in x]
    return x, ftab


ZIG_NORM_X, ZIG_NORM_F = _build_norm_tables()


def _u64_to_f64_exp(bits: int, exponent: int) -> float:
    """rand's ``into_float_with_exponent``: top 52 bits as the mantissa."""
    out_bits = (bits >> 12) | ((1023 + exponent) << 52)
    return struct.unpack("<d", struct.pack("<Q", out_bits))[0]


def _standard_f64(rng: ChaChaRng) -> float:
    """rand's ``Standard`` for f64: 53 bits, multiply-based, [0, 1)."""
    return (rng.next_u64() >> 11) * (1.0 / (1 << 53))


def _open_closed_01(rng: ChaChaRng) -> float:
    """rand's ``OpenClosed01`` for f64: (0, 1]."""
    return ((rng.next_u64() >> 11) + 1) * (1.0 / (1 << 53))


def standard_normal_f64(rng: ChaChaRng) -> float:
    """One sample from rand_distr's StandardNormal (f64 ziggurat)."""
    while True:
        bits = rng.next_u64()
        i = bits & 0xFF
        # u in [-1, 1): convert top 52 bits to [2, 4) and subtract 3.
        u = _u64_to_f64_exp(bits, 1) - 3.0
        x = u * ZIG_NORM_X[i]
        if abs(x) < ZIG_NORM_X[i + 1]:
            return x
        if i == 0:
            # Tail sampling (Marsaglia's method).
            tx, ty = 1.0, 0.0
            while -2.0 * ty < tx * tx:
                tx = math.log(_open_closed_01(rng)) / ZIG_NORM_R
                ty = math.log(_open_closed_01(rng))
            return tx - ZIG_NORM_R if u < 0.0 else ZIG_NORM_R - tx
        if ZIG_NORM_F[i + 1] + (ZIG_NORM_F[i] - ZIG_NORM_F[i + 1]) * _standard_f64(rng) \
                < math.exp(-x * x / 2.0):
            return x


def generate_fixed_normal_sequence(seed: int, length: int) -> np.ndarray:
    """The reference's test fixture generator (tests/util.rs:6-13), exactly.

    Returns the same f32 sequence as ``ChaCha8Rng::seed_from_u64(seed)``
    sampled through ``StandardNormal`` ``length`` times (f32 samples are f64
    casts in rand_distr).
    """
    from . import _native  # C++ fast path, built at its first use

    if _native.available():
        return _native.generate_fixed_normal_sequence(seed, length)
    rng = ChaChaRng.seed_from_u64(seed)
    return np.asarray([standard_normal_f64(rng) for _ in range(length)],
                      dtype=np.float32)
