"""The port's probes (ops/probe_cuda.py, probes/) on the CPU: K4's and K5's
plain twins and the pass probe's variants against the JAX package's own
oracles, exactly."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu_torch.math import gf, ntt
from twenty_first_tpu_torch.ops import ntt_cuda, probe_cuda
from twenty_first_tpu_torch.probes import alu_probe, pass_probe, tip5_probe

REPO = Path(__file__).resolve().parent.parent


def _jax_alu_probe():
    """scripts/pallas_alu_probe.py, loaded by path (it only defines)."""
    spec = importlib.util.spec_from_file_location(
        "pallas_alu_probe", REPO / "scripts" / "pallas_alu_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("log_t", [3, 8])
def test_pass_probe_variants_match_jax_local_pass(log_t):
    """Every variant's plain path against ``ntt._local_pass``, the JAX
    probe's own oracle (prof_pallas_pass.py:166), on (t, 16)."""
    x = np.random.default_rng(log_t).integers(0, P, size=(1 << log_t, 16),
                                              dtype=np.uint64)
    want = jgf.from_limbs(jntt._local_pass(
        tuple(jnp.asarray(v) for v in jgf.to_limbs(x)), log_t, False))
    tw = gf.from_u64(ntt.stage_twiddles(log_t, False)).to("cpu")
    for variant in pass_probe.VARIANTS:
        got = pass_probe.run_pass(gf.from_u64(x), tw, variant, tc=8)
        np.testing.assert_array_equal(gf.to_u64(got), want, err_msg=variant)
    np.testing.assert_array_equal(
        gf.to_u64(pass_probe.plain_pass(gf.from_u64(x), tw)), want)


def test_parse_spec():
    assert pass_probe.parse_spec("12,128") == (12, 128, "grid")
    assert pass_probe.parse_spec("12,128,rt") == (12, 128, "rt")
    assert pass_probe.parse_spec("8,512,ng") == (8, 512, "ng")
    for bad in ("12", "12,128,xx", "1,2,3,4"):
        with pytest.raises(ValueError):
            pass_probe.parse_spec(bad)
    for spec in pass_probe.DEFAULT_SPECS:
        pass_probe.parse_spec(spec)


@pytest.mark.parametrize("layout", ["cols_fast", "elems_fast"])
@pytest.mark.parametrize("log_t", [1, 5])
def test_ntt_stage_chain_is_the_local_pass(layout, log_t):
    """K4's twin, stage by stage (bit reversal first, then in place),
    gives K3's pass on both layouts; the wrapper on a CPU is the twin."""
    rng = np.random.default_rng(20 + log_t)
    t = 1 << log_t
    if layout == "cols_fast":
        x = gf.from_u64(rng.integers(0, P, size=(t, 7), dtype=np.uint64))
    else:
        x = gf.from_u64(rng.integers(0, P, size=(7, t), dtype=np.uint64)).t()
    tw = gf.from_u64(ntt.stage_twiddles(log_t, True)).to("cpu")
    launches = probe_cuda.ntt_stage.launches
    out = probe_cuda.ntt_stage(x, tw, 0, bit_reverse=True)
    for stage in range(1, log_t):
        probe_cuda.ntt_stage(out, tw, stage, out=out)
    assert probe_cuda.ntt_stage.launches == launches  # no kernel on a CPU
    assert torch.equal(out, ntt_cuda.ntt_local_pass_plain(x[None], tw)[0])


def test_ntt_stage_rejects_bad_input():
    x = gf.from_u64(np.arange(32, dtype=np.uint64).reshape(8, 4))
    tw = gf.from_u64(ntt.stage_twiddles(3, False)).to("cpu")
    with pytest.raises(ValueError):
        probe_cuda.ntt_stage(x, tw, 3)  # no such stage
    with pytest.raises(ValueError):
        probe_cuda.ntt_stage(x[:6], tw, 0)  # not a power of two
    with pytest.raises(ValueError):
        probe_cuda.ntt_stage(x, tw[:-1], 0)
    with pytest.raises(ValueError):
        probe_cuda.ntt_stage(x, tw, 0, bit_reverse=True, out=x)
    with pytest.raises(ValueError):
        probe_cuda.ntt_stage(x, tw, 1, out=x.view(4, 8).t())


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("op", ["mul_lazy", "add_lazy"])
def test_gf_chain_plain_matches_the_jax_probe(op, k):
    """K5's twin against the JAX probe's XLA twin ``make_xla(op, k)``
    (pallas_alu_probe.py:55) at (64, 128): the same raw lazy words."""
    rng = np.random.default_rng(30 + k)
    a = rng.integers(0, 1 << 64, size=(64, 128), dtype=np.uint64,
                     endpoint=False)
    b = rng.integers(0, 1 << 64, size=(64, 128), dtype=np.uint64,
                     endpoint=False)
    a[0, :4] = [0, P, P - 1, (1 << 64) - 1]
    b[0, :4] = [(1 << 64) - 1, P, 1 << 32, P - 1]
    probe = _jax_alu_probe()
    want = jgf.from_limbs(probe.make_xla(getattr(jgf, op), k)(
        *jgf.to_limbs(a), *jgf.to_limbs(b)))
    ta, tb = gf.from_u64(a), gf.from_u64(b)
    np.testing.assert_array_equal(
        gf.to_u64(probe_cuda.gf_chain_plain(ta, tb, op, k)), want)
    launches = probe_cuda.gf_chain.launches
    for form in probe_cuda.CHAIN_FORMS:
        np.testing.assert_array_equal(
            gf.to_u64(probe_cuda.gf_chain(ta, tb, op, k, form)), want)
    assert probe_cuda.gf_chain.launches == launches  # no kernel on a CPU


def test_gf_chain_rejects_bad_input():
    a = gf.from_u64(np.arange(8, dtype=np.uint64))
    with pytest.raises(ValueError):
        probe_cuda.gf_chain(a, a, "mul", 1)
    with pytest.raises(ValueError):
        probe_cuda.gf_chain(a, a, "mul_lazy", -1)
    with pytest.raises(ValueError):
        probe_cuda.gf_chain(a, a[:4], "mul_lazy", 1)
    with pytest.raises(ValueError):
        probe_cuda.gf_chain(a, a, "mul_lazy", 1, "fast")
    assert torch.equal(probe_cuda.gf_chain(a, a, "add_lazy", 0), a)


def test_alu_probe_reads_the_step_loop_from_sass():
    sass = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
.L_x_0:
        /*0010*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;
        /*0020*/                   IADD3 R6, R6, 0x1, RZ ;
        /*0030*/              @P0 BRA `(.L_x_0) ;
        /*0040*/                   EXIT ;
.L_x_1:
        /*0050*/                   BRA `(.L_x_1);
"""
    body = alu_probe.loop_body(sass.splitlines())
    assert [line.split()[0] for line in body] == ["IMAD.WIDE.U32", "IADD3",
                                                  "@P0"]
    assert alu_probe.loop_body(sass.replace("`(.L_x_0)", "0x10")
                               .splitlines()) == body[:2] + ["@P0 BRA 0x10"]


def test_alu_probe_reads_each_forms_step_loop(monkeypatch):
    """K5's instantiations by (op, form) in cuobjdump's mangled names: each
    form's own step loop is read, one op being a quarter of it."""
    def sass(n_insns):
        body = [f"        /*{16 * i:04x}*/   IMAD.WIDE.U32 R2, R4, R5, RZ ;"
                for i in range(1, n_insns)]
        return (["        /*0000*/   LDC R1, c[0x0][0x28] ;", ".L_x_0:"]
                + body + [f"        /*{16 * n_insns:04x}*/   @P0 BRA "
                          "`(.L_x_0) ;"])

    forms = list(alu_probe.KERNEL_TAG)
    assert len(forms) == 4  # both ops in both forms
    kernels = {f"_ZN12_GLOBAL__N_115{alu_probe.KERNEL_TAG[f]}vPKmS2_Pmli":
               sass(4 * (1 + i)) for i, f in enumerate(forms)}
    monkeypatch.setattr(alu_probe._build, "sass", lambda library=None:
                        kernels)
    for i, (op, form) in enumerate(forms):
        got = alu_probe.sass_per_op(op, form)
        assert alu_probe.KERNEL_TAG[op, form] in got["kernel"]
        assert got["instructions_per_op"] == 1 + i
        assert got["imad_per_op"] == (4 * (1 + i) - 1) / 4


def test_sass_per_perm_reads_the_innermost_round_loop():
    """Two nested loops (levels around rounds) and a table-load loop: the
    round loop is the innermost one with the most IMAD-family work."""
    sass = """
.L_x_0:
        /*0000*/                   LDS.U8 R1, [R2] ;
        /*0010*/              @P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0020*/                   IADD3 R6, R6, 0x1, RZ ;
.L_x_2:
        /*0030*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;
        /*0040*/                   DFMA R8, R8, R10, R8 ;
        /*0050*/                   IMAD.X R3, RZ, RZ, R3 ;
        /*0060*/              @P1 BRA `(.L_x_2) ;
        /*0070*/              @P2 BRA `(.L_x_1) ;
        /*0080*/                   EXIT ;
"""
    kernels = {"_Z20merkle_commit_kernelv": sass.splitlines()}
    got = alu_probe.sass_per_perm(kernels, "merkle_commit_kernel", 5)
    assert got["round_instructions"] == 4
    assert got["sass_per_perm"] == 20 and got["imad_per_perm"] == 10
    assert got["round_opcodes"]["DFMA"] == 1
    assert alu_probe.sass_per_perm(None, "x", 5)["sass_per_perm"].startswith(
        "not measured")


_PTXAS_LOG = """ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'
ptxas info    : Function properties for _Z1kv
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 156 registers, used 1 barriers, 896 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1jv' for 'sm_90a'
ptxas info    : Function properties for _Z1jv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 28 registers, used 1 barriers
"""


def test_ptxas_report_and_resident_warps(monkeypatch):
    """Registers and spills from the compiler's report; resident warps from
    the CUDA runtime's occupancy, for this build only."""
    rep = tip5_probe.ptxas_report(_PTXAS_LOG)
    assert rep["_Z1kv"] == {"spill_bytes": 16, "registers": 156,
                            "smem_bytes": 896}
    assert rep["_Z1jv"] == {"spill_bytes": 0, "registers": 28,
                            "smem_bytes": 0}
    from twenty_first_tpu_torch import _build
    from twenty_first_tpu_torch.ops import tip5_cuda

    k1 = "_Z19tip5_permute_kernelILi0EEvPKmPmlS1_PKh"
    monkeypatch.setattr(_build, "sass", lambda library=None: None)
    monkeypatch.setattr(_build, "build_log", lambda library=None:
                        _PTXAS_LOG.replace("_Z1kv", k1))
    monkeypatch.setattr(tip5_cuda, "occupancy",
                        lambda name, device=None, threads=256: (threads, 3))
    stats = tip5_probe.kernel_stats()
    assert list(stats) == ["tip5_permute"]
    assert stats["tip5_permute"]["registers"] == 156
    assert stats["tip5_permute"]["spill_bytes"] == 16
    assert stats["tip5_permute"]["resident_warps_per_sm"] == 12
    assert stats["tip5_permute"]["sass_per_perm"].startswith("not measured")
    other = tip5_probe.kernel_stats(Path("other.so"))
    assert "resident_warps_per_sm" not in other["tip5_permute"]


def test_k9_counts_are_per_permutation_with_imma_apart(monkeypatch):
    """K9's warp permutes 32 states, as K1's does: its round loop's counts
    times the rounds are a thread's instructions per permutation (K1's
    unit), and its IMMA instructions are counted apart (none in K1)."""
    sass = """
.L_x_0:
        /*0000*/                   IMMA.16832.U8.U8 R8, R4, R2, RZ ;
        /*0010*/                   IMMA.16832.U8.U8 R12, R4, R3, RZ ;
        /*0020*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;
        /*0030*/                   PRMT R6, R6, 0x5140, R7 ;
        /*0040*/              @P1 BRA `(.L_x_0) ;
        /*0050*/                   EXIT ;
"""
    from twenty_first_tpu_torch import _build
    from twenty_first_tpu_torch.ops import tip5_cuda, tip5_mxu

    k1 = "_Z19tip5_permute_kernelILi0EEvPKmPmlS1_PKh"
    k9 = "_ZN12_GLOBAL__N_123tip5_permute_mma_kernelEPKmPmlS1_PKh"
    log = (_PTXAS_LOG.replace("_Z1kv", k1).replace("_Z1jv", k9))
    monkeypatch.setattr(_build, "sass", lambda library=None: {
        k1: sass.replace("IMMA.16832.U8.U8", "DFMA").splitlines(),
        k9: sass.splitlines()})
    monkeypatch.setattr(_build, "build_log", lambda library=None: log)
    monkeypatch.setattr(tip5_cuda, "occupancy",
                        lambda name, device=None, threads=256: (threads, 3))
    monkeypatch.setattr(tip5_mxu, "occupancy", lambda device=None: (128, 8))
    stats = tip5_probe.kernel_stats()
    assert set(stats) == {"tip5_permute", "tip5_permute_mma"}
    mma = stats["tip5_permute_mma"]
    assert mma["registers"] == 28
    assert mma["sass_per_perm"] == 5 * 5
    assert mma["imad_per_perm"] == 5 and mma["imma_per_perm"] == 10
    assert mma["resident_warps_per_sm"] == 32
    assert stats["tip5_permute"]["sass_per_perm"] == 25
    assert stats["tip5_permute"]["imma_per_perm"] == 0
    got = tip5_probe.counts(stats, "tip5_permute_mma", 16, 1e6)
    assert got["imma_per_perm"] == 10
    assert got["issue_bound_ms"] == pytest.approx(25 * 16 / 1e6 * 1e3)


def test_sass_classes_count_moves_and_shared_loads():
    """The classes of a round loop, per permutation (its counts times the
    rounds): all, IMAD-family (its moves included), the moves ptxas puts on
    the FMA pipe (IMAD.MOV and IMAD.MOV.U32), IMMA of both shapes,
    shared-memory loads of every width; without cuobjdump every class says
    so."""
    st = {"sass_per_perm": 50, "imad_per_perm": 20, "round_opcodes": {
        "IMAD.MOV.U32": 2, "IMAD.MOV": 1, "IMAD.WIDE.U32": 1,
        "IMMA.16816.U8.U8": 2, "IMMA.16832.U8.U8": 1, "LDS.U8": 2,
        "LDS.128": 1, "IADD3": 3}}
    got = tip5_probe.sass_classes(st)
    assert got == {"sass_per_perm": 50, "imad_per_perm": 20,
                   "imad_mov_per_perm": 3 * 5, "imma_per_perm": 3 * 5,
                   "lds_per_perm": 3 * 5}
    assert set(got) == set(tip5_probe.CLASSES)
    missing = tip5_probe.sass_classes(
        {"sass_per_perm": "not measured (no cuobjdump)"})
    assert all(v.startswith("not measured") for v in missing.values())


def test_issue_bound_and_counts():
    stats = {"a": {"sass_per_perm": 100, "registers": 40},
             "b": {"sass_per_perm": 300},
             "c": {"sass_per_perm": "not measured (no cuobjdump)"}}
    assert tip5_probe.issue_bound_ms(stats, {"a": 10, "b": 2}, 1e6) == \
        pytest.approx((100 * 10 + 300 * 2) / 1e6 * 1e3)
    for rate in (None, float("nan")):
        assert tip5_probe.issue_bound_ms(stats, {"a": 1}, rate) == \
            "not measured"
    assert tip5_probe.issue_bound_ms(stats, {"c": 1}, 1e6) == "not measured"
    got = tip5_probe.counts(stats, "a", 10, 1e6)
    assert got["registers"] == 40 and got["spill_bytes"] == "not measured"
    assert got["issue_bound_ms"] == pytest.approx(1.0)


def test_k1_overloads_are_told_apart_by_their_parameters():
    """K1, its absorb mode and the lane mode are one template at kPermute:
    each KERNELS tag picks its own overload by the mangled parameters, and
    a permutation of the lane mode is issued by 16 threads."""
    import re

    mangled = {"tip5_permute": "_Z19tip5_permute_kernelILi0EEvPKmPmlS1_PKh",
               "tip5_absorb": "_Z19tip5_permute_kernelILi0EEvPKmPmlllS1_PKh",
               "tip5_absorb_lanes":
                   "_Z19tip5_permute_kernelILi0EEvPKmPmillS1_PKh"}
    for name, symbol in mangled.items():
        assert [k for k, (tag, _) in tip5_probe.KERNELS.items()
                if re.search(tag, symbol)] == [name]
    stats = {"tip5_absorb_lanes": {"sass_per_perm": 100,
                                   "states_per_warp": 2}}
    assert tip5_probe.issue_bound_ms(
        stats, {"tip5_absorb_lanes": 10}, 1e6) == pytest.approx(
            16 * 100 * 10 / 1e6 * 1e3)


def test_tree_summary_splits_levels_from_the_tail():
    launches = [{"launch": "level", "levels": 1, "rows_in": 8, "ms": 2.0},
                {"launch": "fused", "levels": 2, "rows_in": 4, "ms": 0.5},
                {"launch": "fused", "levels": 1, "rows_in": 1, "ms": 0.25}]
    got = tip5_probe.tree_summary(launches)
    assert got == {"launches": 3, "full_width_level_ms": [2.0],
                   "tail_launches": 2, "tail_levels": 3, "tail_ms": 0.75,
                   "tail_ms_per_level": 0.25}
