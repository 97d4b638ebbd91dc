"""What the CUDA translator emits for the scalar segment kernels, decided
in Python and checked here without a card: which global loads are staged
in shared memory (``repro_torch.core.staging``), why the others are
refused, and what the generated source holds.  The staged and tree-fold
kernels themselves run on the card in ``chip_smoke.py`` (phases 1-2,
against the interpreter and the zoo oracle); here the edge grids that
reach them are held against the JAX reference interpreter through the
plain version (``tests/test_torch_backends.py``)."""
import numpy as np
import pytest

from repro.core import hetir as ref_ir

import repro_torch.zoo  # noqa: F401
from repro_torch import zoo
from repro_torch.core import Engine, OPT_MAX, get_backend
from repro_torch.core import edge_grids as edge
from repro_torch.core import hetir as ir
from repro_torch.core.backends import cuda_backend as cb
from repro_torch.core.backends import nvcc_build
from repro_torch.core.segments import SegNode
from repro_torch.core.staging import (STAGE_BUDGET_BYTES, Refusal,
                                      StagedLoad, plan_staging, stage_layout,
                                      stage_words, staged_loads)


def _optimized(prog, grid, block, args, level):
    return Engine(prog, get_backend("cuda", device="cpu"), grid, block,
                  dict(args), opt_level=level).program


def _verdicts(prog):
    """Every segment's verdicts, by buffer."""
    out = {}
    for seg in cb.program_nodes(prog):
        if isinstance(seg, SegNode):
            for v in plan_staging(seg.stmts, prog, seg.gwrites):
                out.setdefault(v.buf, []).append((seg, v))
    return out


def _attn(level, D=128, T=128, H=2, ntiles=2):
    prog, _ = zoo.attn_decode(D=D, T=T)
    S = ntiles * T
    args = {"Q": np.zeros(H * D, np.float32),
            "K": np.zeros(H * S * D, np.float32),
            "V": np.zeros(H * S * D, np.float32),
            "O": np.zeros(H * D, np.float32), "ntiles": ntiles,
            "scale": np.float32(0.1)}
    return _optimized(prog, H, T, args, level)


@pytest.mark.parametrize("level", [0, OPT_MAX])
def test_attn_decode_stages_the_k_tile_and_refuses_v(level):
    prog = _attn(level)
    got = _verdicts(prog)
    (seg, k), = got["K"]
    assert isinstance(k, StagedLoad)
    # K[((h * ntiles + kt) * T + lane) * D + d]: lane stride D, the QK
    # loop over d, the rest block-uniform
    assert k.lane == 128 and [(c, n) for _, c, n in k.loops] == [(1, 128)]
    assert k.uniform and k.row() == 128
    # the T x D f32 tile, rounded out by a 16-byte chunk for alignment,
    # plus one 16-byte pad per row of 128 words fits the budget
    assert k.words(128) == (128 * 128 + 4) + 4 * 129
    assert k.words(128) * 4 <= STAGE_BUDGET_BYTES
    (_, v), = got["V"]
    assert isinstance(v, Refusal) and v.reason == "non-affine index"
    (_, q), = got["Q"]
    assert isinstance(q, Refusal) and "static trip count" in q.reason


def _loop_program(index, *, write=False, trip=8):
    """One loop of static trip count loading A at ``index(b, t, j)``."""
    b = ir.Builder("loop_load", [ir.Ptr("A"), ir.Ptr("Out")])
    t = b.thread_id()
    s = b.var(b.const(0.0, ir.F32), hint="s")
    with b.loop(trip, hint="j") as j:
        b.assign(s, s + b.load("A", index(b, t, j)))
        if write:
            b.store("A", t, s)
    b.store("Out", b.global_id(0), s)
    prog = b.done()
    args = {"A": np.zeros(4096, np.float32), "Out": np.zeros(64, np.float32)}
    (seg, v), = _verdicts(_optimized(prog, 2, 32, args, 0))["A"]
    return v


def test_staging_refusals():
    assert isinstance(_loop_program(lambda b, t, j: t * b.const(4) + j),
                      StagedLoad)
    written = _loop_program(lambda b, t, j: t * b.const(4) + j, write=True)
    assert written.reason == "the segment writes the buffer"
    # an index through a loaded value, a SELECT, a product of two lane
    # values: not affine in (lane, loop, block-uniform registers)
    for index in (lambda b, t, j: b._emit(ir.CVT, ir.I32,
                                          b.load("Out", t)) + j,
                  lambda b, t, j: b.select(t < b.const(3), t, j),
                  lambda b, t, j: t * t + j):
        assert _loop_program(index).reason == "non-affine index"
    # the loops alone span more than the budget
    big = _loop_program(lambda b, t, j: t + j * b.const(64),
                        trip=STAGE_BUDGET_BYTES // 256 + 1)
    assert big.reason.startswith("footprint over")


def test_footprint_over_the_budget_at_the_launch_block_size():
    """The lane term only the launch knows: fits at a small block, not at
    a large one — the kernel then reads the buffer directly."""
    b = ir.Builder("wide_lanes", [ir.Ptr("A"), ir.Ptr("Out")])
    t = b.thread_id()
    s = b.var(b.const(0.0, ir.F32), hint="s")
    with b.loop(32, hint="j") as j:
        b.assign(s, s + b.load("A", t * b.const(64) + j))
    b.store("Out", b.global_id(0), s)
    prog = _optimized(b.done(), 1, 32, {"A": np.zeros(1 << 16, np.float32),
                                        "Out": np.zeros(32, np.float32)}, 0)
    (_, v), = _verdicts(prog)["A"]
    assert isinstance(v, StagedLoad)
    assert v.words(32) * 4 <= STAGE_BUDGET_BYTES < v.words(1024) * 4
    assert stage_layout([v], 32) == [(True, 0, v.words(32))]
    assert stage_layout([v], 1024)[0][0] is False
    assert stage_words([v], 1024) == 4        # the window's start only


def test_windows_take_the_budget_in_order():
    prog = _optimized(*edge.staged_window_case()[:4], 0)
    seg = next(n for n in cb.program_nodes(prog) if isinstance(n, SegNode))
    loads = staged_loads(plan_staging(seg.stmts, prog, seg.gwrites))
    assert [ld.lane for ld in loads] == [5, 32]
    assert loads[0].row() == 0 and loads[1].row() == 32
    layout = stage_layout(loads, 16)
    assert [on for on, _, _ in layout] == [True, True]
    assert layout[1][1] == layout[0][2]       # back to back
    assert cb.smem_bytes(prog, cb.SegmentSlots(seg, prog, set()), True, 16,
                         loads) >= 4 * stage_words(loads, 16)


def test_emitted_source_of_a_staged_segment():
    src, kernels = cb.emit_module(_attn(OPT_MAX))
    staged = [k for k in kernels.values() if k.staged]
    assert len(staged) == 1 and staged[0].staged[0].buf == "K"
    body = src[src.index(f"het_seg{staged[0].index}_s("):]
    body = body[:body.index('extern "C" int launch_')]
    # K (read-only) is a restrict pointer read through the window; the
    # copy runs ahead of the QK loop, which is unrolled
    assert "const float* __restrict__ g0" in body
    assert "het_stage_copy<128>(st0, sw0, sl0, g0, n0, tid, NT);" in body
    assert "het_stage_ld<128>(st0, sw0, sl0, g0, n0," in body
    assert body.index("het_stage_copy") < body.index("#pragma unroll 8")
    assert "het_block_max<float>" in body and "het_block_add<float, false>" \
        in body
    # the copy itself: 16-byte cp.async by neighbouring threads
    rt = (nvcc_build.CSRC / "hetir_rt.cuh").read_text()
    copy = rt[rt.index("het_stage_copy("):]
    assert "cp.async.cg.shared.global [%0], [%1], 16;" in copy
    # V, refused, still goes through the read-only path
    pv = next(k for k in kernels.values() if "V" in k.slots.buffers)
    body = src[src.index(f"het_seg{pv.index}_s("):]
    body = body[:body.index('extern "C" int launch_')]
    assert "het_ldg(g0, n0," in body and "het_stage" not in body


def test_kernel_source_hash_covers_included_headers(tmp_path, monkeypatch):
    """A kernel that includes a header of csrc/ rebuilds when the header
    changes."""
    kdir = tmp_path / "kernels"
    kdir.mkdir()
    monkeypatch.setattr(nvcc_build, "CSRC", tmp_path)
    monkeypatch.setattr(nvcc_build, "KERNEL_DIR", kdir)
    (kdir / "k.cu").write_text('#include "kernels/h.cuh"\n')
    (kdir / "h.cuh").write_text('#include "kernels/g.cuh"\n// one\n')
    (kdir / "g.cuh").write_text("// one\n")
    first = nvcc_build.kernel_job("k")[1]
    (kdir / "g.cuh").write_text("// two\n")
    second = nvcc_build.kernel_job("k")[1]
    assert second != first
    (kdir / "h.cuh").write_text('#include "kernels/g.cuh"\n// two\n')
    assert nvcc_build.kernel_job("k")[1] not in (first, second)
    assert nvcc_build.local_headers((kdir / "k.cu").read_text()) == \
        [kdir / "h.cuh", kdir / "g.cuh"]


def test_real_kernel_sources_hash_their_headers():
    src = (nvcc_build.KERNEL_DIR / "flash_attention_sm90.cu").read_text()
    assert nvcc_build.local_headers(src) == \
        [nvcc_build.KERNEL_DIR / "sm90.cuh"]
    seg_src, _ = cb.emit_module(_attn(0))
    assert nvcc_build.local_headers(seg_src) == \
        [nvcc_build.CSRC / "hetir_rt.cuh"]


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm"])
def test_f32_kernel_sources_hash_the_simt_header(name):
    # the register-tiled f32 kernels share their product step: an edit of
    # simt_f32.cuh rebuilds both
    src = (nvcc_build.KERNEL_DIR / f"{name}.cu").read_text()
    assert nvcc_build.local_headers(src) == \
        [nvcc_build.KERNEL_DIR / "simt_f32.cuh"]


def test_new_edge_grids_are_in_the_card_run():
    labels = dict(edge.all_cases(ref_ir))
    assert {"reduce_max_ties", "staged_window"} <= set(labels)


# ---------------------------------------------------------------------------
# hetIR blocks wider than 1024 lanes
# ---------------------------------------------------------------------------

def test_lanes_per_thread_cover_any_block():
    assert [cb.lanes_per_thread(T) for T in (1, 32, 1024, 1025, 1536, 2048,
                                             2049, 5000)] == \
        [1, 1, 1, 2, 2, 2, 3, 5]
    for T in (1, 1024, 1025, 2048, 2049, 5000):
        L = cb.lanes_per_thread(T)
        threads = -(-T // L)
        assert threads <= cb.MAX_BLOCK and threads * L >= T


@pytest.mark.parametrize("T", [32, 1024, 1536, 2048])
def test_segment_plan_and_fingerprint_do_not_depend_on_the_block(T):
    # the optimized program, its segments and their kernels' slots are the
    # same at every block size: one library per lane count serves them all
    prog, grid, block, args, _ = edge.divergent_folds_case(block=T)
    want_prog, _, _, wargs, _ = edge.divergent_folds_case(block=32)
    got = _optimized(prog, grid, T, args, OPT_MAX)
    want = _optimized(want_prog, grid, 32, wargs, OPT_MAX)
    assert ir.program_fingerprint(got) == ir.program_fingerprint(want)
    assert [(n.index, n.label) for n in cb.program_nodes(got)
            if isinstance(n, SegNode)] == \
        [(n.index, n.label) for n in cb.program_nodes(want)
         if isinstance(n, SegNode)]
    src, kernels = cb.emit_module(got)
    assert src == cb.emit_module(want)[0]


def test_scalar_source_runs_several_lanes_a_thread():
    prog = _optimized(*edge.divergent_folds_case(block=2048)[:4], 0)
    one, kernels = cb.emit_module(prog)
    two, again = cb.emit_module(prog, lanes=2)
    assert kernels.keys() == again.keys()
    assert "constexpr int HL = 1;" in one and "constexpr int HL = 2;" in two
    body = two[two.index("_s(const HetArgs a)"):]
    body = body[:body.index('extern "C" int launch_')]
    # registers are arrays of the thread's lanes, every lane statement runs
    # in HET_LANES; the folds take the thread's lanes and the block's T
    assert "const int tid = threadIdx.x, NT = blockDim.x;" in body
    assert "[HL];" in body and "HET_LANES(" in body
    assert "het_block_add<float, false>(x" in body and ", tid, NT, T," in body
    assert "het_block_max<float>(x" in body
    assert "__syncthreads_count(" in body and "l_ < HL" in body
    # the scratch is indexed by hetIR lane: sized by T, not by the threads
    assert "scr_v = scr + het_even(T) + 2 * T;" in body
    assert "blockDim" not in body.split("NT = blockDim.x;", 1)[1]
    rt = (nvcc_build.CSRC / "hetir_rt.cuh").read_text()
    lanes = rt[rt.index("#define HET_LANES"):]
    assert "const int t = tid + l_ * NT;" in lanes and "t < T" in lanes
    # the scalar kernel's shared memory follows T whatever the lanes
    seg = next(n for n in cb.program_nodes(prog) if isinstance(n, SegNode))
    sl = cb.SegmentSlots(seg, prog, set())
    assert cb.smem_bytes(prog, sl, True, 2048) == 4 * (2048 + 4 * 2048 + 2)
