"""The port's Tip5 object API (``Digest``, ``Sponge``/``Domain``, the scalar
``Tip5`` sponge and its batch entry points) against the JAX package's,
exactly, on inputs made with numpy. Both packages' scalar Tip5 take their
native host core where it is built."""

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu import errors as jerrors
from twenty_first_tpu.math.b_field_element import P, R, R_INV, bfe
from twenty_first_tpu.tip5 import digest as jdigest
from twenty_first_tpu.tip5 import tip5 as jtip5
from twenty_first_tpu.util_types import sponge as jsponge
from twenty_first_tpu_torch import errors as terrors
from twenty_first_tpu_torch.math import b_field_element as tb
from twenty_first_tpu_torch.tip5 import Digest, Tip5
from twenty_first_tpu_torch.tip5 import digest as tdigest
from twenty_first_tpu_torch.tip5 import tip5 as ttip5
from twenty_first_tpu_torch.util_types import Domain, Sponge
from twenty_first_tpu_torch.util_types import sponge as tsponge

RNG = np.random.default_rng(19)
JDigest, JTip5 = jdigest.Digest, jtip5.Tip5


def _words(n: int) -> list[int]:
    return [int(v) for v in RNG.integers(0, P, size=n, dtype=np.uint64)]


def _vals(seq) -> list[int]:
    return [e.value() for e in seq]


def _jdomain(domain):
    return jsponge.Domain(domain.value)


# --- Digest ------------------------------------------------------------------


DIGEST_CASES = [[1, 2, 3, 4, 5], [0] * 5, [P - 1] * 5, [14, 15, 14, 14, 14],
                _words(5), _words(5)]


@pytest.mark.parametrize("values", DIGEST_CASES)
def test_digest_forms_match_jax(values):
    t, j = Digest(values), JDigest(values)
    assert t.to_hex() == j.to_hex()
    assert t.to_bytes() == j.to_bytes()
    assert str(t) == str(j) and repr(t) == repr(j)
    assert t.to_biguint() == j.to_biguint()
    np.testing.assert_array_equal(t.to_array(), j.to_array())
    assert Digest.try_from_hex(j.to_hex()) == t
    assert Digest.from_bytes(j.to_bytes()) == t
    assert Digest.from_str(str(j)) == t
    assert Digest.from_biguint(j.to_biguint()) == t
    assert Digest.from_array(j.to_array()) == t
    assert _vals(t.reversed()) == _vals(j.reversed())
    assert _vals(t.hash()) == _vals(j.hash())
    assert hash(t) == hash(Digest(values))


def test_digest_ordering_matches_jax():
    cases = DIGEST_CASES + [[2, 0, 0, 0, 0], [1, 0, 0, 0, 1]]
    for a in cases:
        for b in cases:
            got = (Digest(a) < Digest(b), Digest(a) <= Digest(b),
                   Digest(a) > Digest(b), Digest(a) >= Digest(b),
                   Digest(a) == Digest(b))
            want = (JDigest(a) < JDigest(b), JDigest(a) <= JDigest(b),
                    JDigest(a) > JDigest(b), JDigest(a) >= JDigest(b),
                    JDigest(a) == JDigest(b))
            assert got == want, (a, b)


PARSE_ERRORS = {
    "short bytes": ("from_bytes", b"\x01" * 39, "TryFromDigestError"),
    "non-canonical bytes": ("from_bytes", P.to_bytes(8, "little") * 5,
                            "TryFromDigestError"),
    "bad hex": ("try_from_hex", "zz" * 40, "TryFromHexDigestError"),
    "odd hex": ("try_from_hex", "0" * 79, "TryFromHexDigestError"),
    "short hex": ("try_from_hex", "00" * 39, "TryFromDigestError"),
    "four parts": ("from_str", "1,2,3,4", "TryFromDigestError"),
    "non-canonical part": ("from_str", f"1,2,3,4,{P}", "TryFromDigestError"),
    "not a number": ("from_str", "1,2,x,4,5", "TryFromDigestError"),
    "overflow": ("from_biguint", P ** 5, "TryFromDigestError"),
    "negative": ("from_biguint", -1, "TryFromDigestError"),
    "four elements": ("__init__", [1, 2, 3, 4], "TryFromDigestError"),
}


@pytest.mark.parametrize("case", sorted(PARSE_ERRORS))
def test_digest_parse_errors_match_jax(case):
    method, arg, error = PARSE_ERRORS[case]
    for cls, errors in ((JDigest, jerrors), (Digest, terrors)):
        fn = cls if method == "__init__" else getattr(cls, method)
        with pytest.raises(getattr(errors, error)):
            fn(arg)


def test_digest_corruptor_matches_jax():
    d = _words(5)
    for indices, deltas in (([0], [1]), ([1, 4], [P - 1, 7]), ([2], [3])):
        t = tdigest.DigestCorruptor(indices, deltas)
        j = jdigest.DigestCorruptor(indices, deltas)
        assert _vals(t.corrupt(Digest(d))) == _vals(j.corrupt(JDigest(d)))
        assert (_vals(t.corrupt_digest(Digest(d)))
                == _vals(j.corrupt_digest(JDigest(d))))
    for mod in (jdigest, tdigest):
        with pytest.raises(ValueError):
            mod.DigestCorruptor([0], [0])
        with pytest.raises(ValueError):
            mod.DigestCorruptor([0, 1], [1])
        with pytest.raises(ValueError):
            mod.DigestCorruptor([0], [5]).corrupt_digest(
                mod.Digest([5, 0, 0, 0, 0]))


# --- Sponge and the scalar Tip5 ------------------------------------------------


def test_sponge_interface_matches_jax():
    assert [d.value for d in Domain] == [d.value for d in jsponge.Domain]
    assert tsponge.RATE == jsponge.RATE == Tip5.RATE
    base = Sponge()
    with pytest.raises(NotImplementedError):
        Sponge.init()
    with pytest.raises(NotImplementedError):
        base.absorb([0] * 10)
    with pytest.raises(NotImplementedError):
        base.squeeze()


def test_hash10_chained_snapshot():
    # tests/test_tip5.py:27, the reference's snapshot (tip5/mod.rs)
    preimage = [tb.bfe(0)] * 10
    for i in range(6):
        digest = Tip5.hash_10(preimage)
        preimage[i: i + Digest.LEN] = digest
    assert Digest(Tip5.hash_10(preimage)).to_hex() == (
        "109cc2fe453bd9962f754b96d8f5b919"
        "b60af030940a275f5540da195fef65ee651c1b6fa19b2c6a")


def test_hash_varlen_digest_sum_snapshot():
    # tests/test_tip5.py:39
    total = [tb.bfe(0)] * Digest.LEN
    for i in range(20):
        digest = Tip5.hash_varlen([tb.bfe(j) for j in range(i)])
        total = [s + d for s, d in zip(total, digest.values())]
    assert Digest(total).to_hex() == (
        "efbafa86622a9c69652f8a1c4ffd734f"
        "021ad23a0a8085412a877de0f9170b18ea4ff69b6fff9a03")


def test_raw_state_permutation_snapshot():
    # tests/test_tip5.py:65: the snapshot is stated on Montgomery words
    raw_in = [
        0x0000_000F_FFFF_FFF0, 0x0000_0000_FFFF_FFFF, 0x0000_0000_FFFF_FFFF,
        0x0000_0028_FFFF_FFD7, 0x0000_0006_FFFF_FFF9, 0x0000_0002_FFFF_FFFD,
        0x0000_0000_FFFF_FFFF, 0x0000_0030_FFFF_FFCF, 0x0000_0397_FFFF_FC68,
        0x0000_000F_FFFF_FFF0, 0x316B_FB72_3638_2123, 0x216F_521B_66EF_83F5,
        0x5689_D7B3_63F5_2DF0, 0xEB2F_59E3_AEAE_25FC, 0xB082_99D2_77CB_B4DC,
        0xCBE3_D9FD_C534_9140]
    sponge = Tip5.init()
    sponge.state = [tb.bfe((raw * R_INV) % P) for raw in raw_in]
    sponge.permutation()
    assert [(e.value() * R) % P for e in sponge.state[:5]] == [
        0x15D3_8EA9_29F6_632A, 0xF988_E509_FF73_8BB4, 0x48BC_DFAE_88A2_E9F3,
        0x8733_9E83_2DAA_C02A, 0x511E_4126_8150_FDAC]


def test_hash_10_and_hash_pair_match_jax():
    for _ in range(4):
        words = _words(10)
        assert _vals(Tip5.hash_10(words)) == _vals(JTip5.hash_10(words))
        left, right = words[:5], words[5:]
        assert (_vals(Tip5.hash_pair(Digest(left), Digest(right)))
                == _vals(JTip5.hash_pair(JDigest(left), JDigest(right))))


@pytest.mark.parametrize("length", [0, 1, 9, 10, 11, 19, 20, 31])
def test_hash_varlen_matches_jax(length):
    words = _words(length)
    assert _vals(Tip5.hash_varlen(words)) == _vals(JTip5.hash_varlen(words))
    manual = Tip5.init()
    manual.pad_and_absorb_all(words)
    assert _vals(manual.state[:5]) == _vals(Tip5.hash_varlen(words))


@pytest.mark.parametrize("domain", list(Domain))
def test_permutation_and_trace_match_jax(domain):
    t, j = Tip5.new(domain), JTip5.new(_jdomain(domain))
    assert _vals(t.state) == _vals(j.state)
    words = _words(16)
    t.state = [tb.bfe(w) for w in words]
    j.state = [bfe(w) for w in words]
    assert [_vals(row) for row in t.trace()] == [_vals(row) for row in j.trace()]
    t.permutation()
    j.permutation()
    assert _vals(t.state) == _vals(j.state)


def test_absorb_squeeze_match_jax():
    t, j = Tip5.init(), JTip5.init()
    words = _words(10)
    t.absorb(words)
    j.absorb(words)
    for _ in range(3):
        assert _vals(t.squeeze()) == _vals(j.squeeze())
    for cls, errors in ((JTip5, jerrors), (Tip5, terrors)):
        with pytest.raises(errors.SpongeError):
            cls.init().absorb([1] * 9)
        with pytest.raises(errors.SpongeError):
            cls.hash_10([1] * 11)
        with pytest.raises(errors.SpongeError):
            cls.init().sample_indices(1000, 1)


@pytest.mark.parametrize("upper_bound,count", [(1, 5), (2, 13), (1 << 20, 100),
                                               (1 << 32, 21)])
def test_sample_indices_match_jax(upper_bound, count):
    seed = _words(3)
    t, j = Tip5.init(), JTip5.init()
    t.pad_and_absorb_all(seed)
    j.pad_and_absorb_all(seed)
    got = t.sample_indices(upper_bound, count)
    assert got == j.sample_indices(upper_bound, count)
    assert all(0 <= i < upper_bound for i in got)
    assert _vals(t.state) == _vals(j.state)


@pytest.mark.parametrize("count", [0, 1, 3, 4, 7, 10])
def test_sample_scalars_match_jax(count):
    seed = _words(4)
    t, j = Tip5.init(), JTip5.init()
    t.pad_and_absorb_all(seed)
    j.pad_and_absorb_all(seed)
    got = [[c.value() for c in x.coefficients] for x in t.sample_scalars(count)]
    want = [[c.value() for c in x.coefficients] for x in j.sample_scalars(count)]
    assert got == want and len(got) == count


@pytest.mark.parametrize("data", [b"", b"abc", bytes(range(80)),
                                  bytes(range(97)), b"\xff" * 8])
def test_write_finish_match_jax(data):
    t, j = Tip5.init(), JTip5.init()
    t.write(data)
    j.write(data)
    assert t.finish() == j.finish()
    assert _vals(t.state) == _vals(j.state)


def test_hash_varlen_batch_matches_jax():
    lengths = [0, 1, 9, 10, 11, 25, 3, 40, 0, 10]
    inputs = [_words(n) for n in lengths]
    inputs[3] = np.array(inputs[3], dtype=np.uint64)  # arrays pass as they are
    got = Tip5.hash_varlen_batch(inputs, device="cpu")
    want = [JTip5.hash_varlen([int(v) for v in seq]) for seq in inputs]
    assert [_vals(d) for d in got] == [_vals(d) for d in want]
    assert Tip5.hash_varlen_batch([], device="cpu") == []


def test_hash_varlen_array_matches_jax():
    words = np.array(_words(23), dtype=np.uint64)
    got = ttip5.hash_varlen_array(words, device="cpu")
    assert _vals(got) == _vals(jtip5.hash_varlen_array(words))
    assert _vals(got) == _vals(Tip5.hash_varlen([int(w) for w in words]))


def test_scalar_rounds_match_jax_oracle():
    """The copied oracle round by round: S-box layer and whole rounds."""
    state = _words(16)
    assert ttip5._sbox_values(state) == jtip5._sbox_values(state)
    for r in range(5):
        assert ttip5._round_values(state, r) == jtip5._round_values(state, r)
