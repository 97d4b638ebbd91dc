"""Per-segment register liveness of the port (``repro_torch.core.liveness``)
held against the JAX reference.

The port's engine, CUDA kernels and plain version keep only the registers
some later node may read; the reference keeps every register any segment
reads.  Here, on the CPU (the ``cuda`` backend runs its plain version on
CPU tensors) and against the reference interpreter only:

* ``vadd``'s block kernel moves no register at all;
* after every segment of every suite and zoo program, at O0 and OPT_MAX,
  the port's live set lies inside the reference's, and the kernel's
  output slots, the registers the plain version writes back and the
  registers the engine keeps are the one set;
* a port launch paused at any barrier resumes under the reference
  interpreter with bit-equal buffers, and a reference launch paused there
  resumes in the port;
* the analysis's edge cases — registers defined under a predicate and
  then shuffled, read after it or carried to a later segment, a register
  carried round a segment-level loop — against the reference, bit for
  bit.
"""
import numpy as np
import pytest

import repro.zoo  # noqa: F401
from repro.core import Engine as RefEngine
from repro.core import get_backend as ref_backend
from repro.core import hetir as ref_ir
from repro.core import kernels_suite as ref_ks
from repro.core.state import Snapshot as RefSnapshot

import repro_torch.zoo  # noqa: F401
from repro_torch.core import Engine, OPT_MAX, get_backend
from repro_torch.core import hetir as ir
from repro_torch.core import kernels_suite as ks
from repro_torch.core.backends import cuda_backend as cb
from repro_torch.core.liveness import (exposed_reads, live_in, live_out,
                                       segment_inputs, segment_outputs)
from repro_torch.core.segments import SegNode, program_nodes
from repro_torch.core.state import Snapshot

NAMES = list(ref_ks.SUITE) + list(ref_ks.registered_examples("zoo"))
CASES = [(n, lvl) for n in NAMES for lvl in (0, OPT_MAX)]


def _bits(a):
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


def _launch(name):
    prog, _, grid, block, args, outs = ref_ks.example_launch(
        name, rng=np.random.default_rng(42))
    return prog, grid, block, args, outs


def _args(args):
    return {k: np.copy(v) if isinstance(v, np.ndarray) else v
            for k, v in args.items()}


def _ref_run(prog, grid, block, args, level):
    eng = RefEngine(prog, ref_backend("interp"), grid, block, _args(args),
                    opt_level=level)
    assert eng.run()
    return eng


def _port_engine(prog, grid, block, args, level):
    return Engine(ir.from_foreign(prog), get_backend("cuda", device="cpu"),
                  grid, block, _args(args), opt_level=level)


def _assert_same(got, want, outs, what):
    for o in outs:
        np.testing.assert_array_equal(_bits(got.result(o)),
                                      _bits(want.result(o)), err_msg=what)


def test_vadd_block_kernel_moves_no_register():
    prog, _ = ks.vadd()
    eng = Engine(prog, get_backend("cuda", device="cpu"), 4, 32,
                 {"A": np.zeros(128, np.float32),
                  "B": np.zeros(128, np.float32),
                  "C": np.zeros(128, np.float32), "n": 128},
                 opt_level=OPT_MAX)
    src, kernels = cb.emit_module(eng.program)
    (k,) = kernels.values()
    assert k.has_block
    assert (k.slots.inputs, k.slots.outputs) == ([], [])
    body = src[src.index("het_seg0_b("):]
    body = body[:body.index("\n}\n")]
    # three buffer words a lane, nothing else: no register array read or
    # written, and lane -> (b, t) by 32-bit division below 2^31 lanes
    assert "a.ptr[3]" not in body and "[lane]" not in body
    assert "(unsigned)lane / (unsigned)T" in body


@pytest.mark.parametrize("name,level", CASES)
def test_live_sets_match_kernel_plain_version_and_engine(name, level):
    prog, grid, block, args, _ = _launch(name)
    ref_live = RefEngine(prog, ref_backend("interp"), grid, block,
                         _args(args), opt_level=level)._live
    eng = _port_engine(prog, grid, block, args, level)
    _, kernels = cb.emit_module(eng.program)
    seen = []
    run_segment = eng.backend.run_segment

    def watched(seg, state, launch):
        before = set(state.regs)
        run_segment(seg, state, launch)
        seen.append((seg, before, set(state.regs)))

    eng.backend.run_segment = watched
    done = False
    while not done:
        done = eng.run(max_segments=1)
        seg, before, after = seen[-1]
        live = live_out(eng.program, seg)
        outs = segment_outputs(seg, live)
        assert live <= ref_live, (seg.index, sorted(live - ref_live))
        assert sorted(outs) == kernels[seg.index].slots.outputs
        assert sorted(segment_inputs(seg, live)) == \
            kernels[seg.index].slots.inputs
        # the plain version writes back exactly the kernel's outputs ...
        assert after == before | outs, (seg.index, sorted(after ^ before))
        # ... and the engine keeps what is live after the segment
        assert set(eng.state.regs) == after & live
    assert len(seen) >= 1


def _pauses(eng_factory):
    """Snapshots of one launch after each of its segments but the last."""
    eng = eng_factory()
    blobs = []
    while not eng.run(max_segments=1):
        blobs.append(eng.snapshot().to_bytes())
    return blobs


@pytest.mark.parametrize("name,level", CASES)
def test_port_blob_resumes_under_the_reference(name, level):
    prog, grid, block, args, outs = _launch(name)
    want = _ref_run(prog, grid, block, args, level)
    for k, blob in enumerate(_pauses(
            lambda: _port_engine(prog, grid, block, args, level))):
        snap = RefSnapshot.from_bytes(blob)
        dst = RefEngine.resume(prog, ref_backend("interp"), snap)
        assert dst.run()
        _assert_same(dst, want, outs, f"{name} O{level} paused after {k + 1}")


@pytest.mark.parametrize("name,level", CASES)
def test_reference_blob_resumes_in_the_port(name, level):
    prog, grid, block, args, outs = _launch(name)
    want = _ref_run(prog, grid, block, args, level)
    for k, blob in enumerate(_pauses(
            lambda: RefEngine(prog, ref_backend("interp"), grid, block,
                              _args(args), opt_level=level))):
        snap = Snapshot.from_bytes(blob)
        dst = Engine.resume(ir.from_foreign(prog),
                            get_backend("cuda", device="cpu"), snap)
        # the reference's surplus registers are dropped on resume
        assert set(dst.state.regs) <= live_in(dst.program)[dst.node_idx]
        assert dst.run()
        _assert_same(dst, want, outs, f"{name} O{level} paused after {k + 1}")


def _partial_defs():
    """Segment 1 redefines ``r``, ``q`` and ``u`` in the lower half of each
    block only: it shuffles ``r`` from the upper half inside the
    predicate, reads ``q`` after it, and segment 2 reads ``u`` — each of
    them needs segment 0's value in the lanes the predicate left alone."""
    b = ref_ir.Builder("partial_defs", [ref_ir.Ptr("Out"), ref_ir.Ptr("Out2"),
                                        ref_ir.Ptr("Out3")])
    t, g = b.thread_id(), b.global_id(0)
    r, q, u = (b.var(t * k + 1, h) for k, h in ((3, "r"), (5, "q"), (7, "u")))
    b.barrier("b0")
    with b.when(t < 16):
        b.assign(r, t * 0 + 100)
        b.store("Out", g, b.shuffle(r, t ^ 31))
        b.assign(q, t * 0 + 200)
        b.assign(u, t * 0 + 300)
    b.store("Out2", g, q + 1)
    b.barrier("b1")
    b.store("Out3", g, u)
    return b.done()


def _loop_carried():
    """A register defined by the second segment of a segment-level loop
    and read by the first on the next trip, and after the loop."""
    b = ref_ir.Builder("loop_carried", [ref_ir.Ptr("A"), ref_ir.Ptr("Out")])
    g = b.global_id(0)
    acc = b.var(b.const(0.5, ref_ir.F32), "acc")
    with b.loop(3) as i:
        x = b.load("A", g) * acc + i.astype(ref_ir.F32)
        b.barrier("mid")
        b.assign(acc, x)
        b.barrier("end")
    b.store("Out", g, acc)
    return b.done()


@pytest.mark.parametrize("build,args,outs", [
    (_partial_defs, lambda: {o: np.zeros(64, np.float32)
                             for o in ("Out", "Out2", "Out3")},
     ("Out", "Out2", "Out3")),
    (_loop_carried,
     lambda: {"A": np.linspace(-1, 1, 64).astype(np.float32),
              "Out": np.zeros(64, np.float32)}, ("Out",)),
])
@pytest.mark.parametrize("level", [0, OPT_MAX])
def test_liveness_edges_against_the_reference(build, args, outs, level):
    prog = build()
    want = _ref_run(prog, 2, 32, args(), level)
    port = _port_engine(prog, 2, 32, args(), level)
    nodes = program_nodes(port.program)
    segs = [n for n in nodes if isinstance(n, SegNode)]
    lv = live_in(port.program)
    if prog.name == "partial_defs":
        seg0, seg1, _ = segs
        # the shuffle's source and the register read after the predicate
        # are read before any def that covers their lanes; the third is
        # carried through segment 1 for segment 2
        (r,) = [op.args[0].name for op in ir.walk_ops(seg1.stmts)
                if op.opcode == ir.SHUFFLE]
        exposed = exposed_reads(seg1.stmts)
        mine = {x.name for x in seg1.defs if x.name[0] in "rqu"}
        (q,) = exposed & mine - {r}
        (u,) = mine - {r, q}
        assert u not in exposed
        assert u in segment_inputs(seg1, lv[seg1.index + 1])
        assert u in lv[seg0.index + 1] and u in lv[seg1.index + 1]
    else:
        # the loop variable is live throughout its loop, and the carried
        # register is live after the segment that defines it
        first, last = min(s.index for s in segs), max(s.index for s in segs)
        loop_segs = [s for s in segs if first < s.index < last]
        var = next(n.var.name for n in nodes if hasattr(n, "var"))
        assert all(var in lv[s.index + 1] for s in loop_segs)
        assert any(segment_outputs(s, lv[s.index + 1]) - {var}
                   for s in loop_segs)
    assert port.run()
    _assert_same(port, want, outs, prog.name)
