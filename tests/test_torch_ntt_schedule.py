"""K3's round schedule (csrc/ntt.cu) as a plain torch model, and the NTT's
post/out epilogue, against the port's twins and the JAX package, exactly.

The model repeats the kernel's steps with the port's lazy field forms: the
outer-twiddle table each block builds from the last stage of ``tw``, the
rounds of up to four radix-2 stages a thread runs in registers (its
elements, groups and positions as the kernel indexes them), the inner
twiddles as shifts by powers of two, and the canonical epilogue."""

import jax
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import gf_numpy as jgfn
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu_torch.math import gf, ntt
from twenty_first_tpu_torch.math.b_field_element import PRIMITIVE_ROOTS
from twenty_first_tpu_torch.ops import ntt_cuda

#: log2 of the elements a thread holds (ntt.cu's kLogR)
LOG_R = 4
#: e with w_{2^k} = 2^e mod p for the forward roots, by k (ntt.cu's
#: root_exponent); the inverse's is 192 - e
ROOT_EXPONENT = {0: 0, 1: 96, 2: 48, 3: 120, 4: 156, 5: 78, 6: 39}
EDGES = [0, 1, P - 1, 1 << 32, (1 << 32) - 1]


def _rev(x, bits: int):
    """Bit reversal of the low ``bits`` bits of an int64 tensor."""
    r = torch.zeros_like(x)
    for b in range(bits):
        r |= ((x >> b) & 1) << (bits - 1 - b)
    return r


def root_exponent(log_k: int, inverse: bool) -> int:
    e = ROOT_EXPONENT[log_k]
    return (192 - e) % 192 if inverse else e


def butterfly(x, y, e: int):
    """(x + 2^e y, x - 2^e y) with lazy forms; 2^e = -2^(e - 96) for
    e >= 96 swaps the sum and the difference."""
    neg = e >= 96
    f = e - 96 if neg else e
    v = y if f == 0 else gf.mul_by_pow2_lazy(y, f)
    s, d = gf.add_lazy(x, v), gf.sub_lazy(x, v)
    return (d, s) if neg else (s, d)


def dft(a, log_k: int, inverse: bool):
    """In-place DIT DFT over the last axis (a[..., i] holds input rev(i))."""
    a = a.clone()
    for s in range(log_k):
        m = 1 << s
        for j0 in range(0, 1 << log_k, 2 * m):
            for jj in range(m):
                e = root_exponent(s + 1, inverse) * jj % 192
                a[..., j0 + jj], a[..., j0 + jj + m] = butterfly(
                    a[..., j0 + jj], a[..., j0 + jj + m], e)
    return a


def round_tables(tw, log_t: int, log_r: int) -> dict:
    """The outer twiddles w_{KM}^(q r) of every round after the first, by
    its s, laid out [q - 1][r] and built as a block of K3 builds them from
    the last stage of tw (w_t^e, e < t/2; w_t^(e + t/2) = -w_t^e)."""
    t = 1 << log_t
    w = tw[t // 2 - 1:]
    w_all = torch.cat([w, gf.neg(w)])
    tabs = {}
    for s in range(log_r, log_t, log_r):
        k = min(log_r, log_t - s)
        f = torch.arange(((1 << k) - 1) << s)
        q, r = (f >> s) + 1, f & ((1 << s) - 1)
        tabs[s] = w_all[(q * r) << (log_t - s - k)]
    return tabs


def k3_model(x, tw, diag=None, scale: int = 1):
    """K3 on a (B, t, C) view, step by step as the kernel runs it."""
    b, t, c = x.shape
    log_t = t.bit_length() - 1
    inverse = log_t >= 2 and int(tw[t // 2 - 1 + t // 4]) != 1 << 48
    log_r = min(LOG_R, log_t)
    big_r, log_h = 1 << log_r, log_t - log_r
    hs = 1 << log_h
    cols = x.permute(0, 2, 1).reshape(b * c, t)
    h = torch.arange(hs)
    # round 0: thread h transforms elements n * (t / R) + h (group rev(h)),
    # a[i] holding n = rev(i)
    a = cols.view(-1, big_r, hs).transpose(1, 2)
    a = dft(a[..., _rev(torch.arange(big_r), log_r)], log_r, inverse)
    out = torch.empty_like(cols)
    if log_h == 0:
        out[:] = a[:, 0]
    else:
        tabs = round_tables(tw, log_t, log_r)
        pos = torch.empty_like(cols)
        p = torch.arange(big_r)
        pos[:, (_rev(h, log_h)[:, None] << log_r) + p] = a
        s = log_r
        while s + log_r < log_t:  # middle rounds: group h, r = h mod 2^s
            r = h & ((1 << s) - 1)
            base = ((h >> s) << (s + log_r)) + r
            q = _rev(p, log_r)  # a[i] is sub-block i, DFT input rev(i)
            a = pos[:, base[:, None] + (p << s)]
            a = torch.where(q != 0, gf.mul_lazy(
                a, tabs[s][(((q - 1).clamp(min=0)) << s) + r[:, None]]), a)
            pos[:, base[:, None] + (p << s)] = dft(a, log_r, inverse)
            s += log_r
        k = log_t - s  # the last round: R / K groups a thread
        r = (torch.arange(big_r >> k)[:, None] * hs + h)[..., None]
        q = _rev(torch.arange(1 << k), k)
        g = pos[:, (torch.arange(1 << k) << s) + r]
        g = torch.where(q != 0, gf.mul_lazy(
            g, tabs[s][(((q - 1).clamp(min=0)) << s) + r]), g)
        out[:, (torch.arange(1 << k) << s) + r] = dft(g, k, inverse)
    y = out.view(b, c, t).permute(0, 2, 1)
    if diag is not None:
        y = gf.mul(y, diag)
    if scale != 1:
        return gf.mul_const(y, scale)
    return y if diag is not None else gf.canon(y)


def _words(rng, shape):
    v = rng.integers(0, P, size=shape, dtype=np.uint64).ravel()
    v[:len(EDGES)] = EDGES
    v[-len(EDGES):] = EDGES[::-1]
    return v.reshape(shape)


@pytest.mark.parametrize("log_k", range(1, 7))
def test_roots_of_unity_are_the_kernels_powers_of_two(log_k):
    """w_K = root_t^(t / K) is 2^e for every t >= K, both directions."""
    for log_t in range(log_k, 13):
        t = 1 << log_t
        for inverse in (False, True):
            root = PRIMITIVE_ROOTS[t]
            if inverse:
                root = pow(root, P - 2, P)
            assert pow(root, t >> log_k, P) == pow(
                2, root_exponent(log_k, inverse), P)


@pytest.mark.parametrize("log_t", range(1, 13))
def test_k3_model_matches_twin_and_jax(log_t):
    """The model against K3's twin in both directions and JAX's _local_pass
    in one (with a diagonal and a constant; the direction alternates with
    t), on columns holding the edge words."""
    rng = np.random.default_rng(log_t)
    t, cols = 1 << log_t, 3
    for inverse in (False, True):
        vals = _words(rng, (t, cols))
        diag = _words(rng, (t, cols))
        const = pow(t, P - 2, P) if inverse else 5
        x = gf.from_u64(vals)[None]
        tw = gf.from_u64(ntt.stage_twiddles(log_t, inverse))
        dg = gf.from_u64(diag)
        got = k3_model(x, tw)
        assert torch.equal(got, ntt_cuda.ntt_local_pass_plain(x, tw))
        got_epi = k3_model(x, tw, diag=dg, scale=const)
        assert torch.equal(got_epi, ntt_cuda.ntt_local_pass_plain(
            x, tw, diag=dg, scale=const))
        if inverse != bool(log_t % 2):
            continue
        local_pass = jax.jit(lambda lo, hi, dlo, dhi: jntt._local_pass(
            (lo, hi), log_t, inverse, diag=(dlo, dhi), post_const=const))
        want = jgf.from_limbs(local_pass(*jgf.to_limbs(vals),
                                         *jgf.to_limbs(diag)))
        np.testing.assert_array_equal(gf.to_u64(got_epi[0]), want)


@pytest.mark.parametrize("layout", ["cols_fast", "elems_fast"])
def test_k3_model_on_batched_strided_views(layout):
    """Two batches of a strided view, as the four-step passes give them."""
    rng = np.random.default_rng(7)
    vals = _words(rng, (2, 1 << 9, 6))
    x = gf.from_u64(vals)
    if layout == "elems_fast":
        x = gf.from_u64(np.ascontiguousarray(vals.transpose(0, 2, 1)))
        x = x.transpose(1, 2)
    tw = gf.from_u64(ntt.stage_twiddles(9, True))
    assert torch.equal(k3_model(x, tw, scale=3),
                       ntt_cuda.ntt_local_pass_plain(x, tw, scale=3))


@pytest.mark.parametrize("log_n", [0, 1, 5, 12, 13, 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_post_out_matches_ntt_then_mul(log_n, inverse):
    """ntt(post=, out=) into the head of zero planes four times as wide,
    single pass (n <= 2^12) and four-step, against the transform followed
    by the product, and against JAX."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    vals = _words(rng, (3, n)) if n >= 2 * len(EDGES) else rng.integers(
        0, P, size=(3, n), dtype=np.uint64)
    post = rng.integers(1, P, size=n, dtype=np.uint64)
    x, pv = gf.from_u64(vals), gf.from_u64(post)
    planes = torch.zeros((3, 4 * n), dtype=torch.int64)
    got = ntt.ntt(x, inverse, post=pv, out=planes[:, :n])
    assert got.data_ptr() == planes.data_ptr()
    want = gf.mul(ntt.ntt(x, inverse), pv)
    assert torch.equal(planes[:, :n], want)
    assert not planes[:, n:].any()
    jax_nt = jntt.intt_values(vals) if inverse else jntt.ntt_values(vals)
    np.testing.assert_array_equal(gf.to_u64(want),
                                  jgfn.mul(jax_nt, post[None, :]))
    fresh = ntt.ntt(x, inverse, post=pv)
    assert torch.equal(fresh, want)


def test_ntt_post_out_rejects_bad_shapes():
    x = gf.from_u64(np.arange(32, dtype=np.uint64).reshape(2, 16))
    with pytest.raises(ValueError):
        ntt.ntt(x, post=torch.ones(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        ntt.ntt(x, out=torch.empty(2, 8, dtype=torch.int64))
