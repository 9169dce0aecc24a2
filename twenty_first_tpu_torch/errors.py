"""Error types, mirroring the reference's thiserror enums (error.rs:17-71).

A copy of ``twenty_first_tpu/errors.py`` (importing that package would
import JAX); ``tests/test_torch_ntt.py`` asserts every class has the JAX
class's name and bases.
"""

from __future__ import annotations


class TwentyFirstError(Exception):
    """Base class for all library errors."""


class ParseBFieldElementError(TwentyFirstError):
    """Raised when a value cannot be parsed/converted into a canonical
    base-field element (canonicity window is (-p, p); error.rs:17-31)."""


class TryFromXFieldElementError(TwentyFirstError):
    """Raised when an XFieldElement cannot be converted (e.g. unlift of a
    non-base-field element, or a Digest without zero padding)."""


class TryFromDigestError(TwentyFirstError):
    """Raised on invalid digest conversions (wrong length, non-canonical
    element, overflow)."""


class TryFromHexDigestError(TryFromDigestError):
    """Raised on invalid hex digest conversions (bad hex or bad digest)."""


class BFieldCodecError(TwentyFirstError):
    """Raised on invalid BFieldCodec encodings (empty/short/long sequences,
    invalid length indicators)."""


class MerkleTreeError(TwentyFirstError):
    """Raised on invalid Merkle tree operations (merkle_tree.rs:933-965)."""


class MmrError(TwentyFirstError):
    """Raised on invalid MMR operations."""


class U32ToUsizeError(TwentyFirstError):
    """Kept for API parity; never raised on 64-bit Python."""


class PolynomialError(TwentyFirstError, ValueError):
    """Raised on invalid polynomial operations (bad domains, non-clean
    division, invalid arguments). ValueError subclass so generic callers
    degrade sensibly."""


class PolynomialDivisionError(PolynomialError, ZeroDivisionError):
    """Raised on division/reduction by the zero polynomial."""


class LatticeError(TwentyFirstError, ValueError):
    """Raised on invalid lattice-crypto inputs (bad lengths, malformed
    ciphertexts/keys)."""


class SpongeError(TwentyFirstError, ValueError):
    """Raised on invalid sponge/hash inputs (wrong input lengths)."""
