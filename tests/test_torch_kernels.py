"""The port's kernel library (``repro_torch.kernels``) held against the JAX
package's (``repro.kernels``) on the CPU.

Inputs are made from a seed with numpy and handed to both packages.  On
CPU tensors every ``<name>_fwd`` runs its plain PyTorch version, so this
file holds each plain version against the JAX ``<name>_fwd`` (Pallas in
interpret mode), each torch oracle against the JAX oracle, and each
``ops`` gradient against ``jax.grad`` of the JAX op, at the tolerances of
``tests/test_kernels.py``.  The CUDA kernels themselves run on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 5).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels_suite as ref_ks
from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as jax_flash
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_op
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.kernels.hetir_gen.ref import het_kernel_ref as jax_het_ref
from repro.kernels.mlstm_chunk.kernel import mlstm_chunk_fwd as jax_mlstm
from repro.kernels.mlstm_chunk.ops import mlstm_chunk as jax_mlstm_op
from repro.kernels.mlstm_chunk.ref import mlstm_chunk_ref as jax_mlstm_ref
from repro.kernels.moe_gmm.kernel import moe_gmm_fwd as jax_gmm
from repro.kernels.moe_gmm.ops import moe_gmm as jax_gmm_op
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_gmm_ref
from repro.kernels.rglru_scan.kernel import rglru_scan_fwd as jax_rglru
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_op
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref

from repro_torch.core import hetir as ir
from repro_torch.core.backends import nvcc_build
from repro_torch.kernels import (_cuda, flash_attention, mlstm_chunk,
                                 moe_gmm, rglru_scan)
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_fwd, flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.hetir_gen import het_kernel
from repro_torch.kernels.hetir_gen.ref import het_kernel_ref
from repro_torch.kernels.mlstm_chunk.kernel import (mlstm_chunk_fwd,
                                                    mlstm_chunk_plain)
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd, moe_gmm_plain
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_fwd,
                                                   rglru_scan_plain)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

#: bf16 goes to both packages by the same round-to-nearest-even from f32
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _both(arr, dt="f32"):
    arr = np.asarray(arr, np.float32)
    return jnp.asarray(arr, JDT[dt]), torch.from_numpy(arr).to(TDT[dt])


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # B, H, S, d, causal, window, dtype
    "causal-f32": (1, 1, 128, 64, True, None, "f32"),
    "full-bf16": (2, 2, 256, 64, False, None, "bf16"),
    "window64": (1, 2, 256, 64, True, 64, "f32"),
    "window999": (1, 2, 256, 64, True, 999, "f32"),
    "uneven-tail": (1, 1, 192, 64, True, None, "f32"),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_plain_and_ref_match_jax(case):
    B, H, S, d, causal, window, dt = FLASH_CASES[case]
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=(B, H, S, d)), dt) for _ in range(3))
    tol = 2e-2 if dt == "bf16" else 2e-5
    want = jax_flash(jq, jk, jv, causal=causal, window=window, bq=128,
                     bk=128, interpret=True)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    _close(got, want, tol)
    _close(attention_ref(tq, tk, tv, causal=causal, window=window),
           jax_attn_ref(jq, jk, jv, causal=causal, window=window), tol)


def test_flash_attention_grad_matches_jax():
    rng = np.random.default_rng(2)
    arrs = [rng.normal(size=(1, 1, 128, 64)).astype(np.float32)
            for _ in range(3)]
    want = jax.grad(lambda q, k, v: (jax_flash_op(q, k, v, True, None)
                                     ** 2).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (flash_attention(*ts, True, None) ** 2).sum().backward()
    for t, w in zip(ts, want):
        _close(t.grad, w, 1e-3)


# ---------------------------------------------------------------------------
# moe gmm
# ---------------------------------------------------------------------------

def _gmm_inputs(rng, E, C, D, F, counts, dt, zero_dead=True):
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    if zero_dead:   # the contract: rows past counts[e] are zero
        x[np.arange(C)[None, :] >= np.asarray(counts)[:, None]] = 0.0
    w = rng.normal(size=(E, D, F)).astype(np.float32)
    c = np.asarray(counts, np.int32)
    return _both(x, dt), _both(w, dt), (jnp.asarray(c), torch.from_numpy(c))


@pytest.mark.parametrize("E,C,D,F,dt,zero_dead", [
    (4, 128, 128, 256, "f32", True),
    (8, 256, 64, 128, "bf16", True),
    # without the contract only the live 128-row tiles are computed
    (4, 256, 64, 64, "f32", False),
])
def test_moe_gmm_plain_and_ref_match_jax(E, C, D, F, dt, zero_dead):
    rng = np.random.default_rng(3)
    counts = rng.integers(0, C + 1, size=E)
    counts[:2] = (0, 130)
    (jx, tx), (jw, tw), (jc, tc) = _gmm_inputs(rng, E, C, D, F, counts, dt,
                                               zero_dead)
    tol = 5e-2 if dt == "bf16" else 1e-4
    _close(moe_gmm_plain(tx, tw, tc), jax_gmm(jx, jw, jc, interpret=True),
           tol)
    _close(moe_gmm_ref(tx, tw, tc), jax_gmm_ref(jx, jw, jc), tol)


def test_moe_gmm_empty_experts_are_zero():
    rng = np.random.default_rng(4)
    (_, tx), (_, tw), (_, tc) = _gmm_inputs(rng, 4, 128, 64, 64,
                                            [0, 64, 0, 128], "f32")
    out = moe_gmm_fwd(tx, tw, tc).numpy()
    assert np.all(out[0] == 0) and np.all(out[2] == 0)
    assert np.any(out[1] != 0) and np.any(out[3] != 0)


def test_moe_gmm_grad_matches_jax():
    rng = np.random.default_rng(5)
    (jx, tx), (jw, tw), (jc, tc) = _gmm_inputs(rng, 2, 128, 32, 48,
                                               [50, 128], "f32")
    want = jax.grad(lambda x, w: (jax_gmm_op(x, w, jc) ** 2).sum(),
                    argnums=(0, 1))(jx, jw)
    tx.requires_grad_()
    tw.requires_grad_()
    (moe_gmm(tx, tw, tc) ** 2).sum().backward()
    _close(tx.grad, want[0], 1e-3)
    _close(tw.grad, want[1], 1e-3)


# ---------------------------------------------------------------------------
# rglru scan
# ---------------------------------------------------------------------------

def _rglru_inputs(rng, B, S, D, dt):
    a = _both(rng.uniform(0.7, 0.999, (B, S, D)), dt)
    x = _both(rng.normal(size=(B, S, D)) * 0.1, dt)
    h0 = _both(rng.normal(size=(B, D)) * 0.1)
    return a, x, h0


@pytest.mark.parametrize("B,S,D,dt", [(1, 128, 128, "f32"),
                                      (1, 384, 128, "bf16"),
                                      (2, 200, 96, "f32")])
def test_rglru_scan_plain_and_ref_match_jax(B, S, D, dt):
    (ja, ta), (jx, tx), (jh, th) = _rglru_inputs(np.random.default_rng(6),
                                                 B, S, D, dt)
    tol = 3e-2 if dt == "bf16" else 1e-4
    want_h, want_t = jax_rglru(ja, jx, jh, interpret=True)
    got_h, got_t = rglru_scan_plain(ta, tx, th)
    _close(got_h, want_h, tol)
    _close(got_t, want_t, tol)
    ref_h, ref_t = rglru_scan_ref(ta, tx, th)
    jref_h, jref_t = jax_rglru_ref(ja, jx, jh)
    _close(ref_h, jref_h, tol)
    _close(ref_t, jref_t, tol)


def test_rglru_scan_time_tiling_invariance():
    (_, ta), (_, tx), _ = _rglru_inputs(np.random.default_rng(7), 1, 512,
                                        128, "f32")
    h0 = torch.zeros((1, 128))
    h1, _ = rglru_scan_plain(ta, tx, h0, bs=64)
    h2, _ = rglru_scan_plain(ta, tx, h0, bs=256)
    torch.testing.assert_close(h1, h2, atol=1e-5, rtol=1e-5)


def test_rglru_scan_grad_matches_jax():
    (ja, ta), (jx, tx), (jh, th) = _rglru_inputs(np.random.default_rng(8),
                                                 1, 64, 32, "f32")

    def loss(a, x, h0):
        h, hT = jax_rglru_op(a, x, h0)
        return (h ** 2).sum() + (hT ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(ja, jx, jh)
    ts = [t.requires_grad_() for t in (ta, tx, th)]
    h, hT = rglru_scan(*ts)
    ((h ** 2).sum() + (hT ** 2).sum()).backward()
    for t, w in zip(ts, want):
        _close(t.grad, w, 1e-3)


# ---------------------------------------------------------------------------
# mlstm chunk
# ---------------------------------------------------------------------------

def _mlstm_inputs(rng, BH, S, dk, dv, gate_one=False):
    q, k = (_both(rng.normal(size=(BH, S, dk)) * 0.5) for _ in range(2))
    v = _both(rng.normal(size=(BH, S, dv)) * 0.5)
    lf = _both(np.log(rng.uniform(0.9, 0.999, (BH, S, 1))))
    gi = _both(np.ones((BH, S, 1)) if gate_one
               else rng.uniform(0.1, 1.0, (BH, S, 1)))
    return q, k, v, lf, gi


@pytest.mark.parametrize("BH,S,dk,dv,bt", [(1, 128, 64, 64, 64),
                                           (2, 256, 64, 128, 64),
                                           (1, 256, 32, 48, 128)])
def test_mlstm_chunk_plain_and_ref_match_jax(BH, S, dk, dv, bt):
    ins = _mlstm_inputs(np.random.default_rng(9), BH, S, dk, dv)
    jins, tins = [a for a, _ in ins], [b for _, b in ins]
    want_y, want_c = jax_mlstm(*jins, bt=bt, interpret=True)
    got_y, got_c = mlstm_chunk_plain(*tins, bt=bt)
    _close(got_y, want_y, 2e-3)
    _close(got_c, want_c, 2e-3)
    ref_y, ref_c = mlstm_chunk_ref(*tins)
    jref_y, jref_c = jax_mlstm_ref(*jins)
    _close(ref_y, jref_y, 2e-3)
    _close(ref_c, jref_c, 2e-3)


@pytest.mark.parametrize("bt,dk", [(256, 16), (128, 704)])
def test_mlstm_chunk_plain_long_chunks_and_wide_keys_match_jax(bt, dk):
    # the domain the card's kernels now take: chunks past 128 steps (run
    # there as chunks of 128) and keys wider than 640 (S a multiple of bt:
    # the Pallas kernel reads a partial last chunk past the end)
    ins = _mlstm_inputs(np.random.default_rng(15), 1, 512, dk, 8)
    jins, tins = [a for a, _ in ins], [b for _, b in ins]
    want_y, want_c = jax_mlstm(*jins, bt=bt, interpret=True)
    got_y, got_c = mlstm_chunk_plain(*tins, bt=bt)
    _close(got_y, want_y, 2e-3)
    _close(got_c, want_c, 2e-3)
    ref_y, ref_c = jax_mlstm_ref(*jins)
    _close(got_y, ref_y, 2e-3)
    _close(got_c, ref_c, 2e-3)
    # chunks of 128 compute the same function
    y128, c128 = mlstm_chunk_plain(*tins, bt=128)
    _close(y128, want_y, 2e-3)
    _close(c128, want_c, 2e-3)


def test_mlstm_chunk_tiling_invariance():
    ins = _mlstm_inputs(np.random.default_rng(10), 1, 256, 64, 64,
                        gate_one=True)
    tins = [b for _, b in ins]
    y1, c1 = mlstm_chunk_plain(*tins, bt=32)
    y2, c2 = mlstm_chunk_plain(*tins, bt=128)
    torch.testing.assert_close(y1, y2, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(c1, c2, atol=1e-3, rtol=1e-3)


def test_mlstm_chunk_grad_matches_jax():
    ins = _mlstm_inputs(np.random.default_rng(11), 1, 32, 8, 8)
    jins = [a for a, _ in ins]
    ts = [b.requires_grad_() for _, b in ins]

    def loss(*a):
        y, c = jax_mlstm_op(*a)
        return (y ** 2).sum() + (c ** 2).sum()

    want = jax.grad(loss, argnums=tuple(range(5)))(*jins)
    y, c = mlstm_chunk(*ts)
    ((y ** 2).sum() + (c ** 2).sum()).backward()
    for t, w in zip(ts, want):
        _close(t.grad, w, 1e-3)


# ---------------------------------------------------------------------------
# routes, guards and the build
# ---------------------------------------------------------------------------

def _small_calls(device):
    """One small call of each wrapper on ``device``."""
    z = lambda *s: torch.zeros(s, device=device)   # noqa: E731
    return {
        "flash_attention": lambda: flash_attention_fwd(
            z(1, 1, 8, 4), z(1, 1, 8, 4), z(1, 1, 8, 4)),
        "moe_gmm": lambda: moe_gmm_fwd(
            z(2, 8, 4), z(2, 4, 4),
            torch.tensor([3, 0], dtype=torch.int32, device=device)),
        "rglru_scan": lambda: rglru_scan_fwd(z(1, 8, 4), z(1, 8, 4),
                                             z(1, 4)),
        "mlstm_chunk": lambda: mlstm_chunk_fwd(
            z(1, 8, 4), z(1, 8, 4), z(1, 8, 4), z(1, 8, 1), z(1, 8, 1)),
    }


_WRAPPERS = {"flash_attention": flash_attention_fwd, "moe_gmm": moe_gmm_fwd,
             "rglru_scan": rglru_scan_fwd, "mlstm_chunk": mlstm_chunk_fwd}
_N_OPERANDS = {"flash_attention": 3, "moe_gmm": 3, "rglru_scan": 3,
               "mlstm_chunk": 5}


def test_prepare_takes_contiguous_copies_and_computes_f16_in_f32():
    x = torch.arange(24, dtype=torch.float16).reshape(2, 3, 4)
    strided = x.transpose(1, 2)
    (a, b), (g,), (c,) = _cuda.prepare(
        (strided, x), f32=(torch.ones(2, 1, dtype=torch.float64),),
        i32=(torch.tensor([3, 5]),))
    # another floating type: every operand in f32, values exact
    assert a.dtype == b.dtype == torch.float32
    assert a.is_contiguous() and torch.equal(a, strided.float())
    assert g.dtype == torch.float32 and c.dtype == torch.int32
    # back to the first operand's type, as the Pallas bodies' stores
    assert torch.equal(a.to(strided.dtype), strided)
    # one type the kernels compute in: kept; a contiguous one not copied
    bf = torch.ones(4, 3, dtype=torch.bfloat16)
    (k1, k2), _, _ = _cuda.prepare((bf, bf.t()))
    assert k1.dtype == torch.bfloat16 and k1.data_ptr() == bf.data_ptr()
    assert k2.is_contiguous() and torch.equal(k2, bf.t())
    # mixed types: f32, whatever they are
    (m1, m2), _, _ = _cuda.prepare((bf, torch.ones(4, 3)))
    assert m1.dtype == m2.dtype == torch.float32
    with pytest.raises(ValueError, match="floating-point"):
        _cuda.prepare((torch.ones(3, dtype=torch.int32),))


@pytest.mark.parametrize("name", _cuda.KERNELS)
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(name):
    before = _WRAPPERS[name].launches
    out = _small_calls("cpu")[name]()
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.device.type == "cpu" for o in outs)
    assert _WRAPPERS[name].launches == before


@pytest.mark.parametrize("name", _cuda.KERNELS)
def test_meta_tensors_take_the_oracle_and_launch_nothing(name):
    """A dry run's trace: on ``meta`` the wrapper returns the oracle's
    outputs (their shapes and types the plain version's) and launches
    nothing."""
    before = _WRAPPERS[name].launches
    got = _small_calls("meta")[name]()
    want = _small_calls("cpu")[name]()
    got, want = ((o if isinstance(o, tuple) else (o,)) for o in (got, want))
    assert [(o.device.type, o.shape, o.dtype) for o in got] == \
        [("meta", w.shape, w.dtype) for w in want]
    assert _WRAPPERS[name].launches == before


@pytest.mark.parametrize("name", _cuda.KERNELS)
def test_other_devices_are_refused(name):
    """A device that is neither the card, the CPU nor ``meta`` (only the
    operands' ``device`` is read before the refusal)."""
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="xpu"):
        _WRAPPERS[name](*[other] * _N_OPERANDS[name])


def test_kernel_library_hash_covers_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(nvcc_build, "KERNEL_DIR", tmp_path)
    cu = tmp_path / "k.cu"
    cu.write_text("// one\n")
    first = nvcc_build.kernel_job("k")[1]
    assert first.parent == nvcc_build.BUILD_DIR
    assert first.name.startswith("k_") and first.suffix == ".so"
    assert nvcc_build.kernel_job("k")[1] == first
    cu.write_text("// two\n")
    second = nvcc_build.kernel_job("k")[1]
    assert second != first
    monkeypatch.setattr(nvcc_build, "KERNEL_NVCC_FLAGS",
                        nvcc_build.KERNEL_NVCC_FLAGS + ("-lineinfo",))
    assert nvcc_build.kernel_job("k")[1] != second


def test_kernel_flags_keep_ieee_and_hopper():
    flags = " ".join(nvcc_build.KERNEL_NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-ftz=false" in flags and "-prec-div=true" in flags
    assert "fast_math" not in flags and "-ftz=true" not in flags
    for name in _cuda.KERNELS:
        src = (nvcc_build.KERNEL_DIR / f"{name}.cu").read_text()
        assert f'extern "C" int launch_{name}(' in src, name
        assert f"src/repro/kernels/{name}/kernel.py" in src, name


# ---------------------------------------------------------------------------
# hetIR-generated kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vadd", "reduction", "matmul_tiled",
                                  "inclusive_scan"])
def test_het_kernel_on_cpu_bit_equal_to_jax_interp(name):
    prog, _, grid, block, args, _ = ref_ks.example_launch(
        name, rng=np.random.default_rng(42))
    want = jax_het_ref(prog, grid, block)(**dict(args))
    port = ir.from_foreign(prog)
    for fn in (het_kernel(port, grid, block, device="cpu"),
               het_kernel_ref(port, grid, block)):
        got = fn(**dict(args))
        assert set(got) == set(want)
        for buf, arr in want.items():
            assert isinstance(got[buf], np.ndarray)
            np.testing.assert_array_equal(got[buf], np.asarray(arr))


def test_het_kernel_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = ir.from_foreign(ref_ks.example_launch("vadd")[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        het_kernel(prog, 1, 32)
