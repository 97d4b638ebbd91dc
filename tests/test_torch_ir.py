"""The PyTorch port's IR layer held against the JAX reference.

Every suite and zoo program is built by both packages and carried into the
port with ``hetir.from_foreign``; fingerprints, optimized bodies, segment
lists and block-lowering verdicts must be identical, because snapshot
``node_idx`` values and translation-cache keys index them.  Also checked
here: the port imports neither JAX nor the JAX package, and the CUDA
translator emits deterministic source for every segment.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.zoo  # noqa: F401  (registers the reference zoo kernels)
from repro.core import hetir as ref_ir
from repro.core import kernels_suite as ref_ks
from repro.core import passes as ref_passes
from repro.core import segments as ref_segments
from repro.core.backends.base import Backend as RefBackend
from repro.core.engine import Engine as RefEngine

import repro_torch.zoo  # noqa: F401
from repro_torch.core import hetir as ir
from repro_torch.core import kernels_suite as ks
from repro_torch.core import passes, segments
from repro_torch.core.backends.cuda_backend import emit_module

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the pinned block-path verdicts)

NAMES = list(ks.SUITE) + list(ks.registered_examples("zoo"))
LEVELS = (0, passes.OPT_MAX)


def _both(name):
    """(reference program, port program, port program carried over from
    the reference, canonical launch) for kernel ``name``."""
    ref_prog, _, grid, block, args, _ = ref_ks.example_launch(
        name, rng=np.random.default_rng(42))
    port_prog = ks.lookup(name)()[0]
    return ref_prog, port_prog, ir.from_foreign(ref_prog), (grid, block, args)


def _seg_fp(mod, stmts):
    return mod.program_fingerprint(mod.Program("seg", [], list(stmts)))


def _describe(mod, nodes):
    out = []
    for n in nodes:
        kind = type(n).__name__
        if kind == "SegNode":
            out.append((kind, n.index, n.label, _seg_fp(mod, n.stmts),
                        sorted(r.name for r in n.defs),
                        sorted(r.name for r in n.uses),
                        sorted(n.greads), sorted(n.gwrites), n.uses_shared))
        elif kind == "LoopStart":
            out.append((kind, n.index, n.loop_id, n.var.name, n.count))
        else:
            out.append((kind, n.index, n.loop_id, n.start_index))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_programs_carry_over_with_equal_fingerprints(name):
    ref_prog, port_prog, carried, _ = _both(name)
    fp = ref_ir.program_fingerprint(ref_prog)
    assert ir.program_fingerprint(port_prog) == fp
    assert ir.program_fingerprint(carried) == fp
    assert carried.to_text() == ref_prog.to_text()


def test_pipeline_fingerprints_match():
    assert passes.pipeline_fingerprint() == ref_passes.pipeline_fingerprint()
    assert passes.OPT_MAX == ref_passes.OPT_MAX


@pytest.mark.parametrize("name", NAMES)
def test_optimized_and_specialized_bodies_match(name):
    ref_prog, _, carried, (grid, block, args) = _both(name)
    for level in range(passes.OPT_MAX + 1):
        r, _ = ref_passes.get_optimized(ref_prog, level)
        p, _ = passes.get_optimized(carried, level)
        assert ir.program_fingerprint(p) == ref_ir.program_fingerprint(r), \
            f"{name} O{level}"
    # the EXAMPLES launch, specialized on its scalars and buffer extents
    scalars = {p.name: ref_ir.np_dtype(p.dtype).type(args[p.name])
               for p in ref_prog.scalars()}
    shapes = {p.name: tuple(np.shape(args[p.name]))
              for p in ref_prog.buffers()}
    ref_key = ref_passes.SpecializationPolicy().consider(
        ref_prog, passes.OPT_MAX, scalars, override=True, shapes=shapes)
    key = passes.SpecializationPolicy().consider(
        carried, passes.OPT_MAX, scalars, override=True, shapes=shapes)
    assert key == ref_key
    r, _ = ref_passes.get_specialized(ref_prog, passes.OPT_MAX, ref_key)
    p, _ = passes.get_specialized(carried, passes.OPT_MAX, key)
    assert ir.program_fingerprint(p) == ref_ir.program_fingerprint(r)


@pytest.mark.parametrize("name", NAMES)
def test_segment_lists_match(name):
    ref_prog, _, carried, _ = _both(name)
    for level in LEVELS:
        r, _ = ref_passes.get_optimized(ref_prog, level)
        p, _ = passes.get_optimized(carried, level)
        assert _describe(ir, segments.segment_program(p)) == \
            _describe(ref_ir, ref_segments.segment_program(r)), \
            f"{name} O{level}"


def _verdict(mod_ir, mod_passes, seg, B, T, lens):
    plan, reason = mod_passes.block_lower(
        seg.stmts, B, T, mod_passes.choose_block(B * T), buffer_lens=lens)
    if plan is None:
        return None, reason
    return (sorted(plan.tiled), plan.block, plan.grid,
            _seg_fp(mod_ir, plan.stmts)), None


@pytest.mark.parametrize("name", NAMES)
def test_block_lower_verdicts_match(name):
    ref_prog, _, carried, (grid, block, args) = _both(name)
    lens = {p.name: int(np.size(args[p.name])) for p in ref_prog.buffers()}
    for level in LEVELS:
        r, _ = ref_passes.get_optimized(ref_prog, level)
        p, _ = passes.get_optimized(carried, level)
        rsegs = ref_segments.seg_nodes(ref_segments.segment_program(r))
        psegs = segments.seg_nodes(segments.segment_program(p))
        assert [_verdict(ir, passes, s, grid, block, lens) for s in psegs] \
            == [_verdict(ref_ir, ref_passes, s, grid, block, lens)
                for s in rsegs], f"{name} O{level}"


class _VerdictRecorder(RefBackend):
    """A reference backend that runs nothing and records, per executed
    segment, the block-path verdict the reference pallas backend takes."""
    name = "verdicts"

    def __init__(self):
        super().__init__()
        self.stats = {"tiled": 0, "scalar": 0, "reasons": {}}

    def run_segment(self, seg, state, launch):
        B, T = launch.num_blocks, launch.block_size
        lens = {n: np.shape(v)[0] for n, v in state.globals_.items()}
        plan, reason = ref_passes.block_lower(
            seg.stmts, B, T, ref_passes.choose_block(B * T), buffer_lens=lens)
        if plan is not None:
            self.stats["tiled"] += 1
        else:
            self.stats["scalar"] += 1
            cat = ref_passes.refusal_category(reason)
            self.stats["reasons"][cat] = self.stats["reasons"].get(cat, 0) + 1


@pytest.mark.parametrize("name", NAMES)
def test_pinned_block_stats_are_the_references(name):
    """chip_smoke.py checks the card's block_stats against its pinned
    table; the table must be what the reference would record."""
    for level in LEVELS:
        prog, _, grid, block, args, _ = ref_ks.example_launch(
            name, rng=np.random.default_rng(42))
        rec = _VerdictRecorder()
        RefEngine(prog, rec, grid, block, dict(args), opt_level=level).run()
        st = rec.stats
        assert chip_smoke.PINNED_BLOCK_STATS[name][level] == \
            (st["tiled"], st["scalar"], st["reasons"]), f"{name} O{level}"


_FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import repro\b(?!_)|"
                        r"from repro\.)", re.M)


def test_port_sources_never_import_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        text = f.read_text()
        assert not _FORBIDDEN.search(text), f
        for word in ("import jax", "from jax", "import repro", "from repro."):
            # also as a plain substring, outside of repro_torch names
            assert word not in text.replace("repro_torch", "rt"), (f, word)


def test_importing_the_port_loads_no_jax():
    mods = []
    for f in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        rel = f.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    code = "\n".join(
        [f"import {m}" for m in mods]
        + ["import chip_smoke, importlib, sys",
           "bad = [m for m in sys.modules if m == 'jax' or "
           "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]",
           "assert not bad, bad", "print('clean', len(sys.modules))"])
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


_BANNED = ("fmaf", "__expf", "expf", "fminf", "fmaxf", "use_fast_math")


@pytest.mark.parametrize("name", NAMES)
def test_emitter_covers_every_segment_deterministically(name):
    _, _, carried, _ = _both(name)
    for level in LEVELS:
        prog, _ = passes.get_optimized(carried, level)
        src, kernels = emit_module(prog)
        again, _ = emit_module(ir.from_foreign(prog))
        assert again == src, f"{name} O{level}: source not deterministic"
        for word in _BANNED:
            assert word not in src, (name, level, word)
        segs = segments.seg_nodes(segments.segment_program(prog))
        assert sorted(kernels) == [s.index for s in segs]
        for s in segs:
            assert f"void __launch_bounds__(1024) het_seg{s.index}_s(" in src
            assert (f"het_seg{s.index}_b(" in src) == kernels[s.index].has_block
    header = (ROOT / "src" / "repro_torch" / "csrc" / "hetir_rt.cuh").read_text()
    for word in _BANNED:
        assert word not in header, word
