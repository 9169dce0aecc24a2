"""The port's ``InverseTip5`` (``tip5/inverse.py``) and ``blake3_mini``
against the JAX package's, and the Tip5 constants the port lacked before
(``MDS_MATRIX``, ``LOG2_STATE_SIZE``; ``gf.MAX``, ``gf.GENERATOR``).

``InverseTip5`` undoes the port's permutation: the scalar one (native core
and pure-Python rounds) and the batch one (K1's plain twin on the CPU).
``blake3_mini`` re-derives the port's ``ROUND_CONSTANTS``. States come
from numpy seeds."""

import numpy as np
import pytest

import twenty_first_tpu.math.gf as jgf
import twenty_first_tpu.tip5.blake3_mini as jblake
import twenty_first_tpu.tip5.constants as jconst
import twenty_first_tpu.tip5.inverse as jinv
import twenty_first_tpu.tip5.permutation as jperm
from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.math.b_field_element import P
from twenty_first_tpu_torch.tip5 import InverseTip5, Tip5
from twenty_first_tpu_torch.tip5 import blake3_mini as tblake
from twenty_first_tpu_torch.tip5 import constants as tconst
from twenty_first_tpu_torch.tip5 import inverse as tinv
from twenty_first_tpu_torch.tip5 import permutation as tperm
from twenty_first_tpu_torch.tip5 import tip5 as ttip5


def _states(seed: int, rows: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, (rows, 16),
                                                dtype=np.uint64)


def test_constants_equal_jax():
    """ROADMAP C.1 and C.3: the names the port lacked, equal to JAX's."""
    np.testing.assert_array_equal(tconst.MDS_MATRIX, jconst.MDS_MATRIX)
    assert tconst.MDS_MATRIX.dtype == jconst.MDS_MATRIX.dtype == np.uint32
    np.testing.assert_array_equal(tperm.MDS_MATRIX, jperm.MDS_MATRIX)
    assert tconst.LOG2_STATE_SIZE == jconst.LOG2_STATE_SIZE == 4
    assert gf.MAX == jgf.MAX and gf.GENERATOR == jgf.GENERATOR == 7


def test_inverse_constants_equal_jax():
    assert tinv.INV_LOOKUP_TABLE == jinv.INV_LOOKUP_TABLE
    assert tinv.INV_POWER_MAP_EXPONENT == jinv.INV_POWER_MAP_EXPONENT \
        == 10_540_996_611_094_048_183
    assert tinv.INV_MDS_MATRIX_FIRST_COLUMN == jinv.INV_MDS_MATRIX_FIRST_COLUMN
    assert tinv.INV_MDS_MATRIX_FIRST_COLUMN[0] == 0xDCD4BBCC7ABBBDC8
    assert tinv.INV_MDS_MATRIX_FIRST_COLUMN[-1] == 0x1C158A0F5C11FE81


@pytest.mark.parametrize("step", ["inv_sbox_layer", "inv_mds_matrix_mul",
                                  "subtract_constants", "inv_round",
                                  "inv_permutation"])
def test_each_step_equals_jax(step):
    for row in _states(1, 3).tolist():
        t, j = InverseTip5(row), jinv.InverseTip5(row)
        args = (2,) if step in ("subtract_constants", "inv_round") else ()
        getattr(t, step)(*args)
        getattr(j, step)(*args)
        assert [e.value() for e in t.state] == [e.value() for e in j.state]


def test_inverse_undoes_the_scalar_permutation():
    for row in _states(2, 4).tolist():
        for forward in (ttip5._permute_values, ttip5._permute_rounds):
            inv = InverseTip5(forward(row))
            inv.inv_permutation()
            assert [e.value() for e in inv.state] == row
        inv = InverseTip5(ttip5._round_values(row, 3))
        inv.inv_round(3)
        assert [e.value() for e in inv.state] == row
        inv = InverseTip5(ttip5._sbox_values(row))
        inv.inv_sbox_layer()
        assert [e.value() for e in inv.state] == row
    sponge = Tip5.init()
    sponge.permutation()
    inv = InverseTip5(sponge.state)
    inv.inv_permutation()
    assert all(e.value() == 0 for e in inv.state)


def test_inverse_undoes_the_batch_permutation():
    """The batch path on the CPU (K1's plain twin), row by row."""
    states = _states(3, 8)
    permuted = tperm.permutation_batch_values(states, device="cpu")
    for row, out in zip(states.tolist(), permuted.tolist()):
        inv = InverseTip5(out)
        inv.inv_permutation()
        assert [e.value() for e in inv.state] == row


def test_blake3_mini_equals_jax():
    for data in (b"", b"abc", bytes(range(64)), bytes(range(65)),
                 bytes(range(256)) * 4):
        assert tblake.blake3(data) == jblake.blake3(data)
    assert tblake.blake3(b"").hex() == (
        "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")
    with pytest.raises(NotImplementedError):
        tblake.blake3(bytes(1025))


def test_blake3_mini_derives_the_round_constants():
    """blake3("Tip5" || i), its first 16 bytes a little-endian u128 mod p,
    is the raw Montgomery word of round constant i (tip5/mod.rs:1056-1085):
    the canonical value is that times 2^-64."""
    r_inv = pow(1 << 64, P - 2, P)
    derived = [int.from_bytes(tblake.blake3(b"Tip5" + bytes([i]))[:16],
                              "little") % P * r_inv % P
               for i in range(len(tconst.ROUND_CONSTANTS))]
    assert derived == [int(c) for c in tconst.ROUND_CONSTANTS]
