"""The PyTorch port's backends held against the JAX reference interpreter.

Every suite and zoo program runs at O0 and OPT_MAX on the reference
``interp`` and on the port's ``interp`` and ``cuda`` backends — the latter
on CPU tensors, i.e. the plain version of the CUDA segment kernels — and
must give the same bits (NaN compared as NaN) and the same executed-op
count.  One-op programs over edge grids pin the semantics where a CUDA or
PyTorch port would round, wrap or order differently; ``exp_torch`` must
equal ``exp_np`` over the float32 sweep of ``tests/test_model_zoo.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.zoo  # noqa: F401
from repro.core import Engine as RefEngine
from repro.core import get_backend as ref_backend
from repro.core import hetir as ref_ir
from repro.core import kernels_suite as ref_ks

import repro_torch.zoo  # noqa: F401
from repro_torch.core import Engine, OPT_MAX, get_backend
from repro_torch.core import edge_grids as edge
from repro_torch.core import hetir as ir
from repro_torch.core.backends.portable_math import (EXP_MAX_INPUT,
                                                     EXP_MIN_INPUT, exp_np,
                                                     exp_torch)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
import test_fuzz_differential as fuzz  # noqa: E402  (reference generators)

NAMES = list(ref_ks.SUITE) + list(ref_ks.registered_examples("zoo"))
same_bits = chip_smoke.same_bits


def _run(engine_cls, backend, prog, grid, block, args, outs, level):
    eng = engine_cls(prog, backend, grid, block, dict(args), opt_level=level)
    assert eng.run()
    return {o: np.asarray(eng.result(o)) for o in outs}, eng.executed_ops


@pytest.mark.parametrize("level", [0, OPT_MAX])
@pytest.mark.parametrize("name", NAMES)
def test_port_backends_match_reference_interp(name, level):
    prog, _, grid, block, args, outs = ref_ks.example_launch(
        name, rng=np.random.default_rng(42))
    want, ops = _run(RefEngine, ref_backend("interp"), prog, grid, block,
                     args, outs, level)
    port = ir.from_foreign(prog)
    for be in ("interp", "cuda"):
        backend = get_backend(be, device="cpu")
        got, got_ops = _run(Engine, backend, port, grid, block, args, outs,
                            level)
        assert got_ops == ops, (be, got_ops, ops)
        for o in outs:
            assert same_bits(got[o], want[o]), f"{name} O{level} {be}: {o}"
        if be == "cuda":
            st = backend.block_stats
            assert (st["tiled"], st["scalar"], st["reasons"]) == \
                chip_smoke.PINNED_BLOCK_STATS[name][level]
            assert backend.launches == {"scalar": 0, "block": 0}


@pytest.mark.parametrize("corpus", ["main", "memory-op", "attention"])
def test_fuzz_corpora_match_reference_interp(corpus):
    """The first programs of the reference's fixed-seed differential fuzz
    corpora, carried over with ``from_foreign``."""
    make, seed0 = {"main": (fuzz._corpus_case, fuzz.SEED0),
                   "memory-op": (fuzz._mem_corpus_case, fuzz.MEM_SEED0),
                   "attention": (fuzz._attn_corpus_case, fuzz.ATTN_SEED0)
                   }[corpus]
    for seed in range(seed0, seed0 + 12):
        prog, args, grid, block, outs = make(seed)
        for level in (0, OPT_MAX):
            want, ops = _run(RefEngine, ref_backend("interp"), prog, grid,
                             block, args, outs, level)
            for be in ("interp", "cuda"):
                got, got_ops = _run(Engine, get_backend(be, device="cpu"),
                                    ir.from_foreign(prog), grid, block, args,
                                    outs, level)
                assert got_ops == ops
                for o in outs:
                    assert same_bits(got[o], want[o]), \
                        f"{corpus} seed {seed} O{level} {be}: {o}"


def test_exp_torch_matches_exp_np():
    rng = np.random.default_rng(7)
    xs = np.concatenate([
        rng.uniform(-110.0, 95.0, size=50_000).astype(np.float32),
        rng.standard_normal(20_000).astype(np.float32) * 10,
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan,
                  float(EXP_MAX_INPUT), float(EXP_MIN_INPUT),
                  np.nextafter(np.float32(EXP_MAX_INPUT), np.float32(200)),
                  np.nextafter(np.float32(EXP_MIN_INPUT), np.float32(-200)),
                  -87.33655, -87.4, -103.9, 88.72, 1.0, -1.0], np.float32),
    ])
    got = exp_torch(torch.from_numpy(xs)).numpy()
    assert same_bits(got, exp_np(xs))


# ---------------------------------------------------------------------------
# one-op programs over edge grids
# ---------------------------------------------------------------------------

def _check_all(prog, grid, block, args, outs):
    want, ops = _run(RefEngine, ref_backend("interp"), prog, grid, block,
                     args, outs, 0)
    port = ir.from_foreign(prog)
    for be in ("interp", "cuda"):
        got, got_ops = _run(Engine, get_backend(be, device="cpu"), port,
                            grid, block, args, outs, 0)
        assert got_ops == ops
        for o in outs:
            assert same_bits(got[o], want[o]), (prog.name, be, o,
                                                got[o], want[o])
    return want


@pytest.mark.parametrize("op,dt", edge.BINARY_CASES)
def test_binary_ops_on_edge_grids(op, dt):
    _check_all(*edge.binary_case(op, dt, ref_ir))


@pytest.mark.parametrize("src,dst", edge.CVT_CASES)
def test_cvt_on_edge_values(src, dst):
    _check_all(*edge.cvt_case(src, dst, ref_ir))


@pytest.mark.parametrize("op", edge.UNARY_OPS)
def test_float_unary_ops_on_edge_values(op):
    _check_all(*edge.unary_case(op, ref_ir))


def test_reduce_add_of_negative_zeros_is_positive_zero():
    want = _check_all(*edge.neg_zero_fold_case(ref_ir))
    assert not np.signbit(want["S"]).any() and not np.signbit(want["C"]).any()


def test_collectives_fold_in_lane_order_under_divergence():
    _check_all(*edge.divergent_folds_case(ref_ir))


def test_reduce_max_ties_resolve_as_the_lane_order_fold():
    """The CUDA kernel's REDUCE_MAX is a shuffle tree; its result must be
    the fold's: of +0 and -0 the later lane's, the first NaN."""
    want = _check_all(*edge.reduce_max_ties_case(ref_ir))
    m, p = want["M"].reshape(4, 48), want["P"].reshape(4, 48)
    assert np.isnan(m[2]).all()
    # lanes 41-43 hold (+0, -0, +0); lane 43 is off under the predicate
    assert not np.signbit(m[3, 0]) and np.signbit(p[3, 0])


def test_staged_window_reads_wrapped_indices_as_the_interpreter():
    """The loads the CUDA kernel stages in shared memory, at negative
    indices down to -n and up to n - 1, with windows past both ends."""
    _check_all(*edge.staged_window_case(ref_ir))


def test_atomic_add_and_conflicting_stores_follow_lane_order():
    """Float atomics on one address apply block by block, lane by lane (the
    rounding of every add, and the old value each lane sees, depend on
    it); several lanes storing to one address leave the highest lane's
    value."""
    _check_all(*edge.atomic_order_case(ref_ir))


def test_edge_grids_built_by_either_package_are_the_same_programs():
    """chip_smoke.py builds the edge grids with the port's hetIR; the
    tests above build them with the reference's."""
    ref = dict(edge.all_cases(ref_ir))
    port = dict(edge.all_cases())
    assert ref.keys() == port.keys()
    for label, (prog, grid, block, args, outs) in port.items():
        rprog, rgrid, rblock, rargs, routs = ref[label]
        assert ir.program_fingerprint(prog) == \
            ir.program_fingerprint(ir.from_foreign(rprog)), label
        assert (grid, block, outs) == (rgrid, rblock, routs)
        for k in args:
            assert same_bits(args[k], rargs[k]), (label, k)


def test_ptxas_report_names_each_entry_function():
    """chip_smoke.py prints each kernel build's registers and spills under
    the entry function's name and template arguments."""
    log = (
        "ptxas info    : Compiling entry function '_ZN76_GLOBAL__N__3b60e1a2"
        "_43_flash_attention_e33362027cb678609a8efde5_cu_3c24db7316flash_fwd"
        "_kernelILi128ELb1EEEvPKfS2_S2_Pfiiiiif' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN76_GLOBAL__N__x\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114moe_gmm"
        "_kernelI13__nv_bfloat16Lb0EEEvPKT_S4_PKiPS2_iiii' for 'sm_90a'\n"
        "ptxas info    : Used 125 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z5plainPf' for 'sm_90a'\n"
        "ptxas info    : Used 8 registers\n")
    assert chip_smoke.ptxas_report(log) == [
        ("flash_fwd_kernel<Li128ELb1E>",
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
        ("flash_fwd_kernel<Li128ELb1E>",
         "Used 255 registers, used 1 barriers"),
        ("moe_gmm_kernel<13__nv_bfloat16Lb0E>",
         "Used 125 registers, used 1 barriers"),
        ("plain", "Used 8 registers")]
