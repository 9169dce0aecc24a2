"""The Tip5 permutation, its sponges and the Merkle tree, in plain torch.

Follows the Tip5 specification (Szepieniec, Lemmens, Sauer, Threadbare,
Al-Kindi, "The Tip5 Hash Function for Recursive STARKs", 2023) as the
upstream crate twenty-first implements it: 16 words, rate 10, capacity 6,
5 rounds of S-box (words 0..3 through the byte lookup of their Montgomery
form x * 2^64 mod p, words 4..15 to the 7th power), the 16 x 16 circulant
MDS matrix, and the round constants. The constants are frozen copies of
the published ones.

The MDS product runs as a floating-point matrix product of 16-bit limbs
against the matrix's 16-bit entries: each sum is below 2^36, exact in
float64. ``mds_dtype=torch.float32`` is the same product in the precision
below, which rounds those sums: the benchmark's control.
"""

from __future__ import annotations

import torch

from . import goldilocks as gl

STATE_SIZE, RATE, CAPACITY, DIGEST_LENGTH = 16, 10, 6, 5
NUM_ROUNDS, NUM_SPLIT_AND_LOOKUP = 5, 4

#: the offset Fermat cube map x -> (x + 1)^3 - 1 mod 257 on bytes
LOOKUP_TABLE = [((x + 1) ** 3 - 1) % 257 for x in range(256)]
#: SHA-256("Tip5") as little-endian 16-bit chunks; M[i][j] = col[(i - j) % 16]
MDS_FIRST_COLUMN = [
    61402, 1108, 28750, 33823, 7454, 43244, 53865, 12034,
    56951, 27521, 41351, 40901, 12021, 59689, 26798, 17845,
]
#: the 80 round constants, canonical values, round by round
ROUND_CONSTANTS = [
    13630775303355457758, 16896927574093233874, 10379449653650130495, 1965408364413093495,
    15232538947090185111, 15892634398091747074, 3989134140024871768, 2851411912127730865,
    8709136439293758776, 3694858669662939734, 12692440244315327141, 10722316166358076749,
    12745429320441639448, 17932424223723990421, 7558102534867937463, 15551047435855531404,
    17532528648579384106, 5216785850422679555, 15418071332095031847, 11921929762955146258,
    9738718993677019874, 3464580399432997147, 13408434769117164050, 264428218649616431,
    4436247869008081381, 4063129435850804221, 2865073155741120117, 5749834437609765994,
    6804196764189408435, 17060469201292988508, 9475383556737206708, 12876344085611465020,
    13835756199368269249, 1648753455944344172, 9836124473569258483, 12867641597107932229,
    11254152636692960595, 16550832737139861108, 11861573970480733262, 1256660473588673495,
    13879506000676455136, 10564103842682358721, 16142842524796397521, 3287098591948630584,
    685911471061284805, 5285298776918878023, 18310953571768047354, 3142266350630002035,
    549990724933663297, 4901984846118077401, 11458643033696775769, 8706785264119212710,
    12521758138015724072, 11877914062416978196, 11333318251134523752, 3933899631278608623,
    16635128972021157924, 10291337173108950450, 4142107155024199350, 16973934533787743537,
    11068111539125175221, 17546769694830203606, 5315217744825068993, 4609594252909613081,
    3350107164315270407, 17715942834299349177, 9600609149219873996, 12894357635820003949,
    4597649658040514631, 7735563950920491847, 1663379455870887181, 13889298103638829706,
    7375530351220884434, 3502022433285269151, 9231805330431056952, 9252272755288523725,
    10014268662326746219, 15565031632950843234, 1209725273521819323, 6024642864597845108,
]
#: rows of states a chunk of the permutation takes at a time (bounds memory)
CHUNK_ROWS = 1 << 21


class Tip5:
    """The permutation's tables on one device, and the hashes built on it."""

    def __init__(self, device, mds_dtype=torch.float64):
        self.device = torch.device(device)
        self.mds_dtype = mds_dtype
        col = MDS_FIRST_COLUMN
        # out = x @ mds_t, with mds_t[j][i] = M[i][j] = col[(i - j) % 16]
        self.mds_t = torch.tensor(
            [[col[(i - j) % 16] for i in range(16)] for j in range(16)],
            dtype=mds_dtype, device=self.device)
        self.lut = torch.tensor(LOOKUP_TABLE, dtype=torch.int64,
                                device=self.device)
        self.rc = torch.tensor([gl.as_int64(c) for c in ROUND_CONSTANTS],
                               dtype=torch.int64,
                               device=self.device).reshape(NUM_ROUNDS, 16)
        self.to_mont = gl.as_int64(gl.EPSILON)  # 2^64 mod p
        self.from_mont = gl.as_int64(gl.inverse_int(1 << 64))
        self.byte_shifts = torch.arange(0, 64, 8, device=self.device)

    # -- the permutation --------------------------------------------------

    def _sbox(self, state):
        """Both S-box layers in four products over all 16 words: words 0..3
        into Montgomery form, through the byte lookup and out of it again;
        words 4..15 squared, cubed, then x^6 and x^7."""
        low, high = state[:, :NUM_SPLIT_AND_LOOKUP], state[:, NUM_SPLIT_AND_LOOKUP:]
        first = gl.mul(state, torch.cat([torch.full_like(low, self.to_mont),
                                         high], dim=1))
        b = (first[:, :NUM_SPLIT_AND_LOOKUP, None] >> self.byte_shifts) & 0xFF
        looked = (self.lut[b] << self.byte_shifts).sum(-1)  # disjoint bytes
        second = gl.mul(torch.cat([looked, first[:, NUM_SPLIT_AND_LOOKUP:]], dim=1),
                        torch.cat([torch.full_like(low, self.from_mont), high],
                                  dim=1))
        cube = second[:, NUM_SPLIT_AND_LOOKUP:]
        return torch.cat([second[:, :NUM_SPLIT_AND_LOOKUP],
                          gl.mul(gl.mul(cube, cube), high)], dim=1)

    def _mds(self, x):
        limbs = torch.stack([(x >> s) & 0xFFFF for s in (0, 16, 32, 48)],
                            dim=-2)  # (..., 4, 16), each below 2^16
        acc = (limbs.to(self.mds_dtype) @ self.mds_t).to(torch.int64)
        s_lo = acc[..., 0, :] + (acc[..., 1, :] << 16)  # < 2^53
        s_hi = acc[..., 2, :] + (acc[..., 3, :] << 16)
        t = (s_lo >> 32) + (s_hi & gl.M32)
        lo = (s_lo & gl.M32) | (t << 32)
        hi = (s_hi >> 32) + (t >> 32)
        return gl.reduce128(lo, hi)

    def _permute(self, state):
        for r in range(NUM_ROUNDS):
            state = gl.add(self._mds(self._sbox(state)), self.rc[r])
        return state

    def permutation(self, states: torch.Tensor) -> torch.Tensor:
        """(rows, 16) states -> permuted states, CHUNK_ROWS at a time."""
        out = torch.empty_like(states)
        for start in range(0, states.shape[0], CHUNK_ROWS):
            out[start:start + CHUNK_ROWS] = self._permute(
                states[start:start + CHUNK_ROWS])
        return out

    # -- hashes -----------------------------------------------------------

    def hash_fixed(self, rows: torch.Tensor) -> torch.Tensor:
        """(m, w <= 10) inputs -> (m, 5): the fixed-length domain (rate
        zero-padded, capacity all ones), one permutation each."""
        m, w = rows.shape
        states = torch.zeros((m, STATE_SIZE), dtype=torch.int64,
                             device=rows.device)
        states[:, :w] = rows
        states[:, RATE:] = 1
        return self.permutation(states)[:, :DIGEST_LENGTH]

    def hash_pairs(self, children: torch.Tensor) -> torch.Tensor:
        """(2m, 5) digests -> (m, 5): parent j = hash(child 2j, child 2j+1)."""
        return self.hash_fixed(children.reshape(-1, 2 * DIGEST_LENGTH))

    def hash_varlen(self, *tables: torch.Tensor) -> torch.Tensor:
        """(m_i, L) inputs, one or more tables of the same L -> (sum m_i, 5),
        the tables' rows in order: the variable-length sponge. Pad with 1
        and then 0s to a multiple of the rate; from the all-zero state,
        overwrite the rate with each chunk and permute. The tables are
        absorbed side by side, one permutation a chunk for all of them."""
        length = tables[0].shape[1]
        state = torch.zeros((sum(t.shape[0] for t in tables), STATE_SIZE),
                            dtype=torch.int64, device=tables[0].device)
        for start in range(0, length + 1, RATE):
            take = min(RATE, length - start)
            row = 0
            for t in tables:
                rate = state[row:row + t.shape[0], :RATE]
                rate[:, :take] = t[:, start:start + take]
                if take < RATE:  # the last chunk: 1, then 0s
                    rate[:, take] = 1
                    rate[:, take + 1:] = 0
                row += t.shape[0]
            state = self.permutation(state)
        return state[:, :DIGEST_LENGTH]

    def merkle_nodes(self, leafs: torch.Tensor) -> torch.Tensor:
        """(n, 5) leaf digests, n a power of two -> the (2n, 5) node array:
        row 1 the root, rows n.. the leafs, node i's children 2i, 2i+1,
        row 0 all zeros."""
        n = leafs.shape[0]
        nodes = torch.zeros((2 * n, DIGEST_LENGTH), dtype=torch.int64,
                            device=leafs.device)
        nodes[n:] = leafs
        lo = n
        while lo > 1:
            nodes[lo // 2:lo] = self.hash_pairs(nodes[lo:2 * lo])
            lo //= 2
        return nodes

    def merkle_root(self, leafs: torch.Tensor) -> torch.Tensor:
        """(n, 5) leaf digests -> the (5,) root, one level at a time."""
        level = leafs
        while level.shape[0] > 1:
            level = self.hash_pairs(level)
        return level[0]
