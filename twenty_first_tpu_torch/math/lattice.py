"""Lattice crypto in the ring F_p[X]/(X^64 + 1): negacyclic coset-NTT,
module algebra over the ring, message embedding, short/uniform samplers, and
an IND-CCA2 (Fujisaki-Okamoto) KEM.

Mirrors twenty-first/src/math/lattice.rs. The reference hard-codes the
bit-reversed tables of powers of psi (a 128th root of unity with
psi^64 == -1, psi == 2198989700608); here the same tables are *derived* from
the verified layout

    table[m + i] = psi^( (64 / (2m)) * (2 * bitrev(i, log2 m) + 1) )

which reproduces the reference's constants exactly (pinned in tests), so the
NTT-domain wire format (ciphertexts store NTT-domain coefficients!) is
bit-identical. Ring ops are vectorized numpy over (..., 64) blocks on the
host; SHAKE256/SHA3-256 come from hashlib (FIPS 202).

A copy of ``twenty_first_tpu/math/lattice.py`` (importing that package
would import JAX) over the port's ``gf_numpy``; it has no kernel, and the
JAX package runs it on the host too. ``tests/test_torch_lattice.py`` holds
its keys and ciphertexts against the JAX package's byte for byte.
"""

from __future__ import annotations

import functools
import hashlib
import json
from dataclasses import dataclass

import numpy as np

from . import gf_numpy as gfn
from .b_field_element import BFieldElement, bfe, P
from ..errors import LatticeError

N = 64
LOG_N = 6
CYCLOTOMIC_RING_ELEMENT_SIZE_IN_BFES = N

# psi: 128th root of unity with psi^64 == -1 (the reference's table base).
PSI = 2198989700608
PSI_INV = pow(PSI, P - 2, P)
N_INV = pow(N, P - 2, P)
assert pow(PSI, 64, P) == P - 1


def _bitrev(x: int, width: int) -> int:
    r = 0
    for _ in range(width):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _psi_table(base: int) -> np.ndarray:
    table = np.zeros(N, dtype=np.uint64)
    table[0] = 1
    m = 1
    while m < N:
        log_m = m.bit_length() - 1
        for i in range(m):
            e = (N // (2 * m)) * (2 * _bitrev(i, log_m) + 1)
            table[m + i] = pow(base, e, P)
        m *= 2
    return table


POWERS_OF_PSI_BITREVERSED = _psi_table(PSI)
POWERS_OF_PSI_INV_BITREVERSED = _psi_table(PSI_INV)


def coset_ntt_noswap_64(array: np.ndarray) -> np.ndarray:
    """Forward negacyclic NTT, Cooley-Tukey, no bit-reversal swap
    (lattice.rs:113-201). Vectorized over leading dims of (..., 64) AND
    across the stage's butterfly groups (each level's blocks are
    contiguous, so one reshape exposes them as a batch axis — three
    field-op calls per level instead of three per group; the KEM was
    Python-dispatch-bound on the per-group form)."""
    a = np.array(array, dtype=np.uint64)
    batch = a.shape[:-1]
    m, t = 1, N
    while m < N:
        t >>= 1
        blk = a.reshape(batch + (m, 2, t))
        zetas = POWERS_OF_PSI_BITREVERSED[m: 2 * m, None]
        u = blk[..., 0, :]
        v = gfn.mul(blk[..., 1, :], zetas)
        a = np.stack([gfn.add(u, v), gfn.sub(u, v)],
                     axis=-2).reshape(batch + (N,))
        m *= 2
    return a


def coset_intt_noswap_64(array: np.ndarray) -> np.ndarray:
    """Inverse negacyclic NTT, Gentleman-Sande (lattice.rs:17-111);
    group-vectorized like the forward transform."""
    a = np.array(array, dtype=np.uint64)
    batch = a.shape[:-1]
    t, h = 1, N // 2
    for _ in range(LOG_N):
        blk = a.reshape(batch + (h, 2, t))
        zetas = POWERS_OF_PSI_INV_BITREVERSED[h: 2 * h, None]
        u = blk[..., 0, :]
        v = blk[..., 1, :]
        a = np.stack([gfn.add(u, v), gfn.mul(gfn.sub(u, v), zetas)],
                     axis=-2).reshape(batch + (N,))
        t *= 2
        h >>= 1
    return gfn.mul(a, np.uint64(N_INV))


class CyclotomicRingElement:
    """A residue class in F_p[X]/(X^64+1), 64 coefficients (np.uint64)."""

    __slots__ = ("coefficients",)

    def __init__(self, coefficients):
        arr = _as_u64_array(coefficients, N)
        self.coefficients = arr

    @classmethod
    def zero(cls) -> "CyclotomicRingElement":
        return cls(np.zeros(N, dtype=np.uint64))

    def is_zero(self) -> bool:
        return not self.coefficients.any()

    @classmethod
    def sample_short(cls, randomness: bytes) -> "CyclotomicRingElement":
        if len(randomness) < 8 * N:
            raise LatticeError(f"need at least {8 * N} randomness bytes")
        return cls(_sample_short_rows(randomness[: 8 * N]).reshape(N))

    @classmethod
    def sample_uniform(cls, randomness: bytes) -> "CyclotomicRingElement":
        if len(randomness) < 9 * N:
            raise LatticeError(f"need at least {9 * N} randomness bytes")
        return cls(_sample_uniform_rows(randomness[: 9 * N]).reshape(N))

    @staticmethod
    def hadamard(a: "CyclotomicRingElement", b: "CyclotomicRingElement"
                 ) -> "CyclotomicRingElement":
        return CyclotomicRingElement(gfn.mul(a.coefficients, b.coefficients))

    def ntt(self) -> "CyclotomicRingElement":
        return CyclotomicRingElement(coset_ntt_noswap_64(self.coefficients))

    def intt(self) -> "CyclotomicRingElement":
        return CyclotomicRingElement(coset_intt_noswap_64(self.coefficients))

    def __add__(self, other):
        return CyclotomicRingElement(
            gfn.add(self.coefficients, other.coefficients)
        )

    def __sub__(self, other):
        return CyclotomicRingElement(
            gfn.sub(self.coefficients, other.coefficients)
        )

    def __mul__(self, other):
        """Negacyclic multiplication via coset-NTT (lattice.rs:299-319)."""
        a = coset_ntt_noswap_64(self.coefficients)
        b = coset_ntt_noswap_64(other.coefficients)
        return CyclotomicRingElement(coset_intt_noswap_64(gfn.mul(a, b)))

    def __eq__(self, other):
        return isinstance(other, CyclotomicRingElement) and \
            np.array_equal(self.coefficients, other.coefficients)

    def to_bfes(self) -> list[BFieldElement]:
        return [bfe(int(c)) for c in self.coefficients]


def embed_msg(msg: bytes) -> CyclotomicRingElement:
    """32-byte message -> ring element: one bit per 16-bit chunk, at bit 15
    (lattice.rs:333-353)."""
    if len(msg) != 32:
        raise LatticeError("message must be exactly 32 bytes")
    embedding = np.zeros(N, dtype=np.uint64)
    for i, byte in enumerate(msg):
        lo = 0
        for j in range(4):
            lo += ((byte >> j) & 1) << (15 + 16 * j)
        embedding[2 * i] = lo
        hi = 0
        for j in range(4):
            hi += ((byte >> (4 + j)) & 1) << (15 + 16 * j)
        embedding[2 * i + 1] = hi
    return CyclotomicRingElement(embedding)


def extract_msg(embedding: CyclotomicRingElement) -> bytes:
    """Round each 16-bit chunk to the nearest embedded bit (lattice.rs:355-387)."""
    msg = bytearray(32)
    coeffs = embedding.coefficients
    for ctr in range(32):
        byte = 0
        for half in range(2):
            value = int(coeffs[2 * ctr + half])
            for j in range(4):
                chunk = value & 0xFFFF
                value >>= 16
                bit = 0 if (chunk < (1 << 14) or (1 << 16) - chunk < (1 << 14)) \
                    else 1
                byte |= bit << (4 * half + j)
        msg[ctr] = byte
    return bytes(msg)


_NUM_SET_BITS = np.array([bin(i).count("1") for i in range(256)],
                         dtype=np.uint64)
_SHORT_SHIFTS = np.arange(48, -1, -16, dtype=np.uint64)  # 16*(3-i)


def _sample_short_rows(randomness: bytes) -> np.ndarray:
    """Vectorized sample_short_bfield_element over len(randomness)//8
    coefficients: popcount difference of two 4-byte halves, packed into
    16-bit chunks (lattice.rs:410-421). Returns (k,) uint64 canonical."""
    b = np.frombuffer(randomness, dtype=np.uint8).reshape(-1, 8)
    pc = _NUM_SET_BITS[b]  # (k, 8) uint64
    left = np.sum(pc[:, :4] << _SHORT_SHIFTS, axis=1)
    right = np.sum(pc[:, 4:] << _SHORT_SHIFTS, axis=1)
    return gfn.sub(left, right)


_U32_MOD_P = np.uint64(0xFFFF_FFFF)  # 2^64 mod P


def _sample_uniform_rows(randomness: bytes) -> np.ndarray:
    """Vectorized sample_uniform: each 9 big-endian bytes taken mod P
    (lattice.rs:423-424 wire rule). Returns (k,) uint64 canonical."""
    b = np.frombuffer(randomness, dtype=np.uint8).reshape(-1, 9)
    hi = b[:, 0].astype(np.uint64)  # the 2^64 digit
    lo_hi = np.zeros(b.shape[0], dtype=np.uint64)
    lo_lo = np.zeros(b.shape[0], dtype=np.uint64)
    for i in range(1, 5):
        lo_hi = (lo_hi << 8) | b[:, i]
        lo_lo = (lo_lo << 8) | b[:, i + 4]
    # value = hi*2^64 + lo_hi*2^32 + lo_lo; all three digits canonical
    acc = gfn.add(gfn.mul(hi, _U32_MOD_P),
                  gfn.mul(lo_hi, np.uint64(1) << np.uint64(32)))
    return gfn.add(acc, lo_lo)


def sample_short_bfield_element(randomness: bytes) -> BFieldElement:
    """Centered-binomial-ish sampler: popcount difference of two 4-byte
    halves, packed into 16-bit chunks (lattice.rs:410-421)."""
    if len(randomness) != 8:
        raise LatticeError("need exactly 8 randomness bytes")
    return bfe(int(_sample_short_rows(randomness)[0]))


class ModuleElement:
    """A matrix of ring elements, stored flat as (n, 64) np.uint64
    (mirrors ModuleElement<N>, lattice.rs:426-590)."""

    __slots__ = ("elements",)

    def __init__(self, elements):
        if isinstance(elements, np.ndarray):
            if elements.ndim != 2 or elements.shape[1] != N:
                raise LatticeError("module elements must be (rows, 64)")
            self.elements = elements.astype(np.uint64)
        else:
            self.elements = np.stack(
                [e.coefficients if isinstance(e, CyclotomicRingElement)
                 else _as_u64_array(e, N) for e in elements]
            )

    @property
    def n(self) -> int:
        return self.elements.shape[0]

    @classmethod
    def zero(cls, n: int) -> "ModuleElement":
        return cls(np.zeros((n, N), dtype=np.uint64))

    @classmethod
    def sample_short(cls, randomness: bytes, n: int) -> "ModuleElement":
        if len(randomness) < 8 * N * n:
            raise LatticeError("not enough randomness for short sampling")
        return cls(_sample_short_rows(randomness[: 8 * N * n])
                   .reshape(n, N))

    @classmethod
    def sample_uniform(cls, randomness: bytes, n: int) -> "ModuleElement":
        if len(randomness) < 9 * N * n:
            raise LatticeError("not enough randomness for uniform sampling")
        return cls(_sample_uniform_rows(randomness[: 9 * N * n])
                   .reshape(n, N))

    def ntt(self) -> "ModuleElement":
        return ModuleElement(coset_ntt_noswap_64(self.elements))

    def intt(self) -> "ModuleElement":
        return ModuleElement(coset_intt_noswap_64(self.elements))

    def ring_element(self, i: int) -> CyclotomicRingElement:
        return CyclotomicRingElement(self.elements[i])

    @staticmethod
    def multiply_hadamard(lhs: "ModuleElement", rhs: "ModuleElement",
                          h: int, inner: int, w: int) -> "ModuleElement":
        """Matrix multiply with Hadamard ring products (NTT domain)."""
        if lhs.n != h * inner or rhs.n != inner * w:
            raise LatticeError("module shapes do not match the matmul")
        lm = lhs.elements.reshape(h, inner, N)
        rm = rhs.elements.reshape(inner, w, N)
        out = np.zeros((h, w, N), dtype=np.uint64)
        for i in range(inner):
            prod = gfn.mul(lm[:, i, None, :], rm[None, i, :, :])
            out = gfn.add(out, prod)
        return ModuleElement(out.reshape(h * w, N))

    @staticmethod
    def multiply(lhs: "ModuleElement", rhs: "ModuleElement",
                 h: int, inner: int, w: int) -> "ModuleElement":
        """Matrix multiply with full (coefficient-domain) ring products."""
        if lhs.n != h * inner or rhs.n != inner * w:
            raise LatticeError("module shapes do not match the matmul")
        out = [[CyclotomicRingElement.zero() for _ in range(w)]
               for _ in range(h)]
        for r in range(h):
            for c in range(w):
                for i in range(inner):
                    out[r][c] = out[r][c] + (
                        lhs.ring_element(r * inner + i)
                        * rhs.ring_element(i * w + c)
                    )
        return ModuleElement([out[r][c] for r in range(h) for c in range(w)])

    @staticmethod
    def fast_multiply(lhs: "ModuleElement", rhs: "ModuleElement",
                      h: int, inner: int, w: int) -> "ModuleElement":
        """NTT -> Hadamard matmul -> iNTT (lattice.rs fast_multiply)."""
        out_ntt = ModuleElement.multiply_hadamard(
            lhs.ntt(), rhs.ntt(), h, inner, w
        )
        return out_ntt.intt()

    def __add__(self, other):
        return ModuleElement(gfn.add(self.elements, other.elements))

    def __sub__(self, other):
        return ModuleElement(gfn.sub(self.elements, other.elements))

    def __eq__(self, other):
        return isinstance(other, ModuleElement) and \
            np.array_equal(self.elements, other.elements)


def _as_u64_array(values, expected_len: int) -> np.ndarray:
    if isinstance(values, np.ndarray) and values.dtype == np.uint64:
        arr = values.copy()
    else:
        arr = np.array(
            [v.value() if isinstance(v, BFieldElement) else int(v)
             for v in values],
            dtype=np.uint64,
        )
    if arr.shape != (expected_len,):
        raise LatticeError(f"expected exactly {expected_len} elements")
    return arr


# ---------------------------------------------------------------------------
# KEM (lattice.rs mod kem, :632-835): IND-CCA2 via Fujisaki-Okamoto
# ---------------------------------------------------------------------------


@dataclass
class SecretKey:
    """KEM secret key. The reference zeroizes key material on drop
    (lattice.rs SecretKey derive(Zeroize)); Python cannot guarantee that,
    but `zeroize()` scrubs the buffers for callers that manage lifetimes."""

    key: bytes  # 32 bytes
    seed: bytes  # 32 bytes

    def to_bytes(self) -> bytes:
        return bytes(self.key) + bytes(self.seed)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if len(data) != 64:
            raise LatticeError("SecretKey needs exactly 64 bytes")
        return cls(key=data[:32], seed=data[32:])

    def to_json(self) -> str:
        return json.dumps({"key": self.key.hex(), "seed": self.seed.hex()})

    @classmethod
    def from_json(cls, s: str) -> "SecretKey":
        obj = json.loads(s)
        return cls(key=bytes.fromhex(obj["key"]),
                   seed=bytes.fromhex(obj["seed"]))

    def zeroize(self) -> None:
        self.key = bytes(32)
        self.seed = bytes(32)


def _module_to_bytes(m: ModuleElement) -> bytes:
    return m.elements.astype("<u8").tobytes()


def _module_from_bytes(data: bytes, rows: int) -> ModuleElement:
    arr = np.frombuffer(data, dtype="<u8").astype(np.uint64)
    if arr.shape != (rows * N,):
        raise LatticeError(f"expected {rows * N} u64 words")
    return ModuleElement(arr.reshape(rows, N))


@dataclass
class PublicKey:
    seed: bytes  # 32 bytes
    ga: ModuleElement  # 4-vector, NTT domain

    def to_bytes(self) -> bytes:
        return bytes(self.seed) + _module_to_bytes(self.ga)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        if len(data) != 32 + 4 * N * 8:
            raise LatticeError("PublicKey has the wrong byte length")
        return cls(seed=data[:32], ga=_module_from_bytes(data[32:], 4))

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed.hex(),
                           "ga": self.ga.elements.reshape(-1).tolist()})

    @classmethod
    def from_json(cls, s: str) -> "PublicKey":
        obj = json.loads(s)
        arr = np.array(obj["ga"], dtype=np.uint64).reshape(4, N)
        return cls(seed=bytes.fromhex(obj["seed"]), ga=ModuleElement(arr))


@dataclass
class Ciphertext:
    bg: ModuleElement  # 4-vector, NTT domain
    bga_m: ModuleElement  # 1-vector, NTT domain

    def to_bfes(self) -> list[BFieldElement]:
        flat = np.concatenate([self.bg.elements.reshape(-1),
                               self.bga_m.elements.reshape(-1)])
        return [bfe(int(v)) for v in flat]

    @classmethod
    def from_bfes(cls, elements) -> "Ciphertext":
        if len(elements) != CIPHERTEXT_SIZE_IN_BFES:
            raise LatticeError(
                f"Ciphertext needs {CIPHERTEXT_SIZE_IN_BFES} elements")
        flat = np.array([bfe(e).value() for e in elements], dtype=np.uint64)
        return cls(
            bg=ModuleElement(flat[: 4 * N].reshape(4, N)),
            bga_m=ModuleElement(flat[4 * N:].reshape(1, N)),
        )

    def to_bytes(self) -> bytes:
        return _module_to_bytes(self.bg) + _module_to_bytes(self.bga_m)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Ciphertext":
        if len(data) != 5 * N * 8:
            raise LatticeError("Ciphertext has the wrong byte length")
        return cls(bg=_module_from_bytes(data[: 4 * N * 8], 4),
                   bga_m=_module_from_bytes(data[4 * N * 8:], 1))

    def to_json(self) -> str:
        return json.dumps({
            "bg": self.bg.elements.reshape(-1).tolist(),
            "bga_m": self.bga_m.elements.reshape(-1).tolist(),
        })

    @classmethod
    def from_json(cls, s: str) -> "Ciphertext":
        obj = json.loads(s)
        return cls(
            bg=ModuleElement(
                np.array(obj["bg"], dtype=np.uint64).reshape(4, N)),
            bga_m=ModuleElement(
                np.array(obj["bga_m"], dtype=np.uint64).reshape(1, N)),
        )


CIPHERTEXT_SIZE_IN_BFES = N * 5


def shake256(data: bytes, num_out_bytes: int) -> bytes:
    return hashlib.shake_256(data).digest(num_out_bytes)


@functools.lru_cache(maxsize=8)
def _derive_public_matrix(seed: bytes) -> ModuleElement:
    """Uniform 4x4 public matrix from the pk seed. Cached: the matrix is
    deterministic PUBLIC data re-derived on every enc and every FO
    re-encryption in dec (callers treat ModuleElements as immutable)."""
    randomness = shake256(seed, 9 * 64 * 16)
    return ModuleElement.sample_uniform(randomness, 16)


def _derive_secret_vectors(seed: bytes) -> tuple[ModuleElement, ModuleElement]:
    num_bytes = 2 * 4 * 64 * 8
    randomness = shake256(seed, num_bytes)
    a = ModuleElement.sample_short(randomness[: num_bytes // 2], 4)
    b = ModuleElement.sample_short(randomness[num_bytes // 2:], 4)
    return a, b


def _derive_public_key(key: bytes, seed: bytes) -> PublicKey:
    a, c = _derive_secret_vectors(key)
    g = _derive_public_matrix(seed)
    stacked = coset_ntt_noswap_64(np.concatenate(
        [a.elements, c.elements], axis=0))
    ga = ModuleElement.multiply_hadamard(
        g, ModuleElement(stacked[:4]), 4, 4, 1) + ModuleElement(stacked[4:])
    return PublicKey(seed=seed, ga=ga)


def keygen(randomness: bytes) -> tuple[SecretKey, PublicKey]:
    if len(randomness) != 32:
        raise LatticeError("keygen needs exactly 32 randomness bytes")
    seed = shake256(randomness + b"\x00", 32)
    key = shake256(randomness + b"\x01", 32)
    sk = SecretKey(key=key, seed=seed)
    pk = _derive_public_key(key, seed)
    return sk, pk


def _generate_ciphertext_derandomized(pk: PublicKey, payload: bytes
                                      ) -> Ciphertext:
    b, d = _derive_secret_vectors(payload)
    m = embed_msg(payload)
    # one batched transform for b (4), d (4) and the embedded message
    stacked = coset_ntt_noswap_64(np.concatenate(
        [b.elements, d.elements, m.coefficients[None]], axis=0))
    b_ntt = ModuleElement(stacked[:4])
    d_ntt = ModuleElement(stacked[4:8])
    m_ntt = ModuleElement(stacked[8:])
    g = _derive_public_matrix(pk.seed)
    bg = ModuleElement.multiply_hadamard(b_ntt, g, 1, 4, 4) + d_ntt
    bga_m = ModuleElement.multiply_hadamard(b_ntt, pk.ga, 1, 4, 1) + m_ntt
    return Ciphertext(bg=bg, bga_m=bga_m)


def enc(pk: PublicKey, randomness: bytes) -> tuple[bytes, Ciphertext]:
    payload = shake256(randomness, 32)
    ciphertext = _generate_ciphertext_derandomized(pk, payload)
    shared_key = hashlib.sha3_256(payload).digest()
    return shared_key, ciphertext


def dec(sk: SecretKey, ctxt: Ciphertext) -> bytes | None:
    a, _ = _derive_secret_vectors(sk.key)
    bga = ModuleElement.multiply_hadamard(ctxt.bg, a.ntt(), 1, 4, 1)
    m = (ctxt.bga_m - bga).intt()
    payload = extract_msg(m.ring_element(0))
    pk = _derive_public_key(sk.key, sk.seed)
    if _generate_ciphertext_derandomized(pk, payload) != ctxt:
        return None
    return hashlib.sha3_256(payload).digest()
