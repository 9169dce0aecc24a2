"""Minimal pure-Python BLAKE3 (single-chunk inputs, 32-byte output).

A copy of ``twenty_first_tpu/tip5/blake3_mini.py`` (importing that package
would import JAX); ``tests/test_torch_tip5_inverse.py`` re-derives the
port's ``ROUND_CONSTANTS`` with it.

Vendored so the Tip5 round-constant derivation chain
(reference: twenty-first/src/tip5/mod.rs:1056-1085, which regenerates
ROUND_CONSTANTS from blake3("Tip5" || i)) is verifiable in environments
without the `blake3` wheel. Implements the BLAKE3 compression function and
the single-chunk hashing path (inputs <= 1024 bytes, which covers the
5-byte derivation inputs with room to spare); raises on longer inputs
rather than growing a chunk tree nobody here needs.

Self-checked against the official test vectors for b"" and b"abc" at
import time.
"""

from __future__ import annotations

_IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
_MASK = 0xFFFFFFFF

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
ROOT = 1 << 3


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(v, a, b, c, d, mx, my):
    v[a] = (v[a] + v[b] + mx) & _MASK
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _MASK
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + my) & _MASK
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _MASK
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress(h, block_words, counter, block_len, flags):
    v = list(h) + list(_IV[:4]) + [
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags]
    m = list(block_words)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[i] for i in _PERM]
    return [v[i] ^ v[i + 8] for i in range(8)]


def _words(block: bytes):
    return [int.from_bytes(block[i:i + 4], "little") for i in range(0, 64, 4)]


def blake3(data: bytes) -> bytes:
    """32-byte BLAKE3 hash of a single-chunk (<= 1024 byte) input."""
    if len(data) > 1024:
        raise NotImplementedError("blake3_mini handles single-chunk inputs")
    blocks = [data[i:i + 64] for i in range(0, len(data), 64)] or [b""]
    h = list(_IV)
    for i, block in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == len(blocks) - 1:
            flags |= CHUNK_END | ROOT
        padded = block + b"\x00" * (64 - len(block))
        h = _compress(h, _words(padded), 0, len(block), flags)
    return b"".join(w.to_bytes(4, "little") for w in h)


# Official BLAKE3 test vectors (github.com/BLAKE3-team/BLAKE3, test_vectors).
assert blake3(b"").hex() == (
    "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")
