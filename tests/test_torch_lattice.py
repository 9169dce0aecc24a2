"""The port's lattice module (``math/lattice.py``) against the JAX
package's: the cases of ``tests/test_lattice.py`` through both packages,
the same randomness in, byte-equal keys, ciphertexts and shared secrets
out. Inputs come from numpy seeds."""

import hashlib

import numpy as np
import pytest

import twenty_first_tpu.math.lattice as jlat
import twenty_first_tpu_torch.math.lattice as tlat
from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu_torch import errors as terrors
from twenty_first_tpu_torch.math.b_field_element import P, bfe

PACKAGES = {"port": tlat, "jax": jlat}


def _bytes(seed: int, n: int = 32) -> bytes:
    return bytes(np.random.default_rng(seed).integers(0, 256, n,
                                                      dtype=np.uint8))


def _words(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def test_psi_tables_and_constants_equal_jax():
    for name in ("POWERS_OF_PSI_BITREVERSED", "POWERS_OF_PSI_INV_BITREVERSED"):
        np.testing.assert_array_equal(getattr(tlat, name), getattr(jlat, name))
    for name in ("N", "LOG_N", "PSI", "PSI_INV", "N_INV",
                 "CYCLOTOMIC_RING_ELEMENT_SIZE_IN_BFES",
                 "CIPHERTEXT_SIZE_IN_BFES"):
        assert getattr(tlat, name) == getattr(jlat, name), name
    # the reference's hard-coded entries (lattice.rs:17-201)
    fwd, inv = tlat.POWERS_OF_PSI_BITREVERSED, tlat.POWERS_OF_PSI_INV_BITREVERSED
    assert [int(fwd[i]) for i in (0, 1, 8, 16, 32, 63)] == [
        1, 281474976710656, 64, 8, 2198989700608, 18446743794540871745]
    assert [int(inv[i]) for i in (1, 8, 63)] == [
        18446462594437873665, 18158513693329981441, 18446741870424883713]


@pytest.mark.parametrize("rows", [1, 5])
def test_coset_ntt_and_intt_equal_jax(rows):
    x = _words(rows, (rows, 64))
    f = tlat.coset_ntt_noswap_64(x)
    np.testing.assert_array_equal(f, jlat.coset_ntt_noswap_64(x))
    np.testing.assert_array_equal(tlat.coset_intt_noswap_64(x),
                                  jlat.coset_intt_noswap_64(x))
    np.testing.assert_array_equal(tlat.coset_intt_noswap_64(f), x)


def _schoolbook(a, b) -> np.ndarray:
    out = [0] * 64
    for i in range(64):
        for j in range(64):
            prod = int(a[i]) * int(b[j]) % P
            k = i + j
            out[k % 64] = (out[k % 64] + (-prod if k >= 64 else prod)) % P
    return np.array(out, dtype=np.uint64)


def test_ring_arithmetic_equals_jax_and_the_schoolbook():
    a, b = _words(3, 64), _words(4, 64)
    ta, tb_ = tlat.CyclotomicRingElement(a), tlat.CyclotomicRingElement(b)
    ja, jb = jlat.CyclotomicRingElement(a), jlat.CyclotomicRingElement(b)
    for got, want in ((ta * tb_, ja * jb), (ta + tb_, ja + jb),
                      (ta - tb_, ja - jb), (ta.ntt(), ja.ntt()),
                      (ta.intt(), ja.intt()),
                      (tlat.CyclotomicRingElement.hadamard(ta, tb_),
                       jlat.CyclotomicRingElement.hadamard(ja, jb))):
        np.testing.assert_array_equal(got.coefficients, want.coefficients)
    np.testing.assert_array_equal((ta * tb_).coefficients, _schoolbook(a, b))
    assert [e.value() for e in ta.to_bfes()] == [e.value() for e in ja.to_bfes()]
    assert tlat.CyclotomicRingElement.zero().is_zero() and not ta.is_zero()


@pytest.mark.parametrize("h,inner,w", [(1, 4, 1), (2, 2, 2), (1, 4, 4)])
def test_module_products_equal_jax(h, inner, w):
    lhs, rhs = _words(10 + h, (h * inner, 64)), _words(20 + w, (inner * w, 64))
    tl, tr = tlat.ModuleElement(lhs), tlat.ModuleElement(rhs)
    jl, jr = jlat.ModuleElement(lhs), jlat.ModuleElement(rhs)
    for fn in ("multiply", "fast_multiply", "multiply_hadamard"):
        got = getattr(tlat.ModuleElement, fn)(tl, tr, h, inner, w)
        want = getattr(jlat.ModuleElement, fn)(jl, jr, h, inner, w)
        np.testing.assert_array_equal(got.elements, want.elements)
    assert tlat.ModuleElement.multiply(tl, tr, h, inner, w) == \
        tlat.ModuleElement.fast_multiply(tl, tr, h, inner, w)


@pytest.mark.parametrize("seed", range(3))
def test_samplers_equal_jax(seed):
    r = _bytes(seed, 9 * 64 * 4)
    for cls in ("CyclotomicRingElement", "ModuleElement"):
        args = () if cls == "CyclotomicRingElement" else (4,)
        for sampler in ("sample_short", "sample_uniform"):
            got = getattr(getattr(tlat, cls), sampler)(r, *args)
            want = getattr(getattr(jlat, cls), sampler)(r, *args)
            field = "coefficients" if args == () else "elements"
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
    for chunk in (r[:8], bytes([0xFF] + [0] * 7), bytes([0] * 4 + [0xFF] * 4)):
        assert tlat.sample_short_bfield_element(chunk).value() == \
            jlat.sample_short_bfield_element(chunk).value()
    assert tlat.sample_short_bfield_element(bytes([0xFF, 0, 0, 0, 0, 0, 0,
                                                   0])) == bfe(8 << 48)


def test_message_embedding_equals_jax():
    msg = _bytes(5)
    got, want = tlat.embed_msg(msg), jlat.embed_msg(msg)
    np.testing.assert_array_equal(got.coefficients, want.coefficients)
    noise = tlat.CyclotomicRingElement(
        np.random.default_rng(6).integers(0, 1 << 10, 64, dtype=np.uint64))
    assert tlat.extract_msg(got) == msg == tlat.extract_msg(got + noise)
    assert tlat.extract_msg(got + noise) == jlat.extract_msg(
        jlat.CyclotomicRingElement((got + noise).coefficients))


def test_shake_and_sha3_kats():
    assert tlat.shake256(b"", 32).hex() == (
        "46b9dd2b0ba88d13233b3feb743eeb243fcd52ea62b81b82b50c27646ed5762f")
    assert tlat.shake256(b"abc", 100) == jlat.shake256(b"abc", 100)
    assert hashlib.sha3_256(b"").hexdigest() == (
        "a7ffc6f8bf1ed76651c14756a061d662f580ff4de43b49fa82d80a4b80f8434a")


@pytest.mark.parametrize("seed", range(3))
def test_kem_is_byte_equal_to_jax(seed):
    """keygen, enc and dec from the same randomness: equal bytes and JSON
    from both packages, and the round trip holds."""
    key_rand, enc_rand = _bytes(100 + seed), _bytes(200 + seed)
    tsk, tpk = tlat.keygen(key_rand)
    jsk, jpk = jlat.keygen(key_rand)
    assert tsk.to_bytes() == jsk.to_bytes()
    assert tpk.to_bytes() == jpk.to_bytes()
    assert tsk.to_json() == jsk.to_json() and tpk.to_json() == jpk.to_json()
    tshared, tct = tlat.enc(tpk, enc_rand)
    jshared, jct = jlat.enc(jpk, enc_rand)
    assert tshared == jshared
    assert tct.to_bytes() == jct.to_bytes() and tct.to_json() == jct.to_json()
    assert [e.value() for e in tct.to_bfes()] == \
        [e.value() for e in jct.to_bfes()]
    assert tlat.dec(tsk, tct) == tshared == jlat.dec(jsk, jct)
    assert tlat.enc(tpk, enc_rand) == (tshared, tct)  # deterministic


def test_kem_rejects_corruption_as_jax():
    results = {}
    for name, lat in PACKAGES.items():
        sk, pk = lat.keygen(bytes(32))
        shared, ct = lat.enc(pk, bytes(range(32)))
        bad = ct.bg.elements.copy()
        bad[0, 0] ^= np.uint64(1)
        tampered = lat.Ciphertext(bg=lat.ModuleElement(bad), bga_m=ct.bga_m)
        other_sk, _ = lat.keygen(bytes([1] * 32))
        results[name] = (lat.dec(sk, tampered), lat.dec(other_sk, ct),
                         lat.dec(sk, ct) == shared)
    assert results["port"] == results["jax"] == (None, None, True)


def test_kem_serialization_roundtrips():
    sk, pk = tlat.keygen(_bytes(99))
    shared, ct = tlat.enc(pk, _bytes(98))
    assert tlat.SecretKey.from_bytes(sk.to_bytes()) == sk
    assert tlat.PublicKey.from_bytes(pk.to_bytes()) == pk
    assert tlat.Ciphertext.from_bytes(ct.to_bytes()) == ct
    assert tlat.SecretKey.from_json(sk.to_json()) == sk
    assert tlat.PublicKey.from_json(pk.to_json()) == pk
    ct2 = tlat.Ciphertext.from_json(ct.to_json())
    assert ct2 == ct and tlat.dec(sk, ct2) == shared
    assert tlat.Ciphertext.from_bfes(ct.to_bfes()) == ct
    # a JAX ciphertext carried in by its bytes decapsulates with the port
    jsk, jpk = jlat.keygen(_bytes(99))
    _, jct = jlat.enc(jpk, _bytes(98))
    assert tlat.dec(sk, tlat.Ciphertext.from_bytes(jct.to_bytes())) == shared
    sk.zeroize()
    assert sk.key == bytes(32) and sk.seed == bytes(32)


def test_bad_lengths_raise_lattice_errors():
    for fn, arg in ((tlat.SecretKey.from_bytes, b"short"),
                    (tlat.PublicKey.from_bytes, b"short"),
                    (tlat.Ciphertext.from_bytes, b"short"),
                    (tlat.keygen, b"short"), (tlat.embed_msg, b"short"),
                    (tlat.Ciphertext.from_bfes, [1, 2]),
                    (tlat.sample_short_bfield_element, b"short"),
                    (tlat.CyclotomicRingElement, [1, 2])):
        with pytest.raises(terrors.LatticeError):
            fn(arg)
