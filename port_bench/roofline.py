"""The yardstick's peaks and its frozen counts of work.

Peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet and its table of
arithmetic throughput for compute capability 9.0), at the
card's full 700 W power limit; a run prints the limit it read beside the
shares.

* device memory: 3.35e12 bytes/s;
* 32-bit integer multiply-add (IMAD) lanes: 64 an SM x 132 SMs x the
  1,980 MHz maximum SM clock.

A kernel's least time is the larger of its bytes over the memory rate and
its IMAD work over the IMAD rate. Bytes count each input byte read once
and each output byte written once. IMAD work counts the field products the
algorithm defines, converted at a fixed rate, whatever unit a kernel runs
them on (tensor cores or FP64 included): a product of two 64-bit words is
4 IMAD (four 32 x 32 -> 64 partial products), a square 3. A Tip5
permutation is 1,250: x^7 on 12 words in each of 5 rounds (two squares,
two products: 5 * 12 * 2 * (3 + 4) = 840) and the MDS as two 16-point
cyclic convolutions a round of 41 products each (5 * 2 * 41 = 410).
"""

from __future__ import annotations

MEMORY_BYTES_PER_S = 3.35e12
SMS = 132
IMAD_LANES_PER_SM = 64
MAX_SM_CLOCK_HZ = 1.98e9
IMAD_PER_S = SMS * IMAD_LANES_PER_SM * MAX_SM_CLOCK_HZ

IMAD_PER_MUL, IMAD_PER_SQUARE = 4, 3
POW7_IMAD_PER_PERM = 5 * 12 * 2 * (IMAD_PER_SQUARE + IMAD_PER_MUL)
MDS_PRODUCTS = 41
MDS_IMAD_PER_PERM = 5 * 2 * MDS_PRODUCTS
IMAD_PER_PERM = POW7_IMAD_PER_PERM + MDS_IMAD_PER_PERM

WORD = 8  # bytes of a field element
STATE_BYTES = 16 * WORD
DIGEST_BYTES = 5 * WORD


def least_seconds(nbytes: float, imads: float) -> tuple[float, str]:
    """(the least time, "bytes" or "products": which bound binds)."""
    mem, ops = nbytes / MEMORY_BYTES_PER_S, imads / IMAD_PER_S
    return (mem, "bytes") if mem >= ops else (ops, "products")


def share(least_s: float, measured_s: float):
    """The least time as a percentage of the measured one; None when
    nothing was measured."""
    return 100.0 * least_s / measured_s if measured_s > 0 else None


def hash_work(work: dict) -> tuple[int, int]:
    """Bytes and IMAD of the leaf hashes or sponge absorbs of one
    operation: each permutation reads and writes one 16-word state."""
    perms = work["hash_perms"]
    return 2 * STATE_BYTES * perms, IMAD_PER_PERM * perms


def tree_work(work: dict) -> tuple[int, int]:
    """Bytes and IMAD of one Merkle tree: the leaf digests read once, the
    nodes the operation keeps written once, one permutation a parent."""
    leafs = work["tree_leafs"]
    nbytes = DIGEST_BYTES * (leafs + work["tree_nodes_out"])
    return nbytes, IMAD_PER_PERM * (leafs - 1)


def ntt_work(work: dict) -> tuple[int, int]:
    """Bytes and IMAD of one operation's transforms: each (columns, length)
    transform reads and writes its columns once, with (length / 2) log2
    length products a column; and one product per scaled coefficient."""
    nbytes = products = 0
    for columns, length in work["ntt"]:
        nbytes += 2 * WORD * columns * length
        products += columns * (length // 2) * (length.bit_length() - 1)
    products += work["ntt_scaled"]
    return nbytes, IMAD_PER_MUL * products
