"""The hand-written CUDA kernels of ``repro_torch.kernels`` on the card,
each held against its plain PyTorch version on the same card, at small and
uneven shapes that reach the kernels' edges: head widths that are not a
power of two, kv and q tails, windows, experts with no live row, rows
past the counts, partial chunks and every chunk build.  Both flash
attention kernels are here: f32 on the CUDA cores, bf16 on wgmma/TMA
(every head-width build, held to one bf16 step); and both grouped matmul
kernels: bf16 on wgmma/TMA where TMA can load the rows, the CUDA-core
kernel otherwise, each case asserting by launch count which one ran.

Marked ``gpu``: without a CUDA device every test skips.  On a machine with
one (no jax needed), from the checkout root:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, mlstm_chunk, moe_gmm, \
    rglru_scan
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_fwd, flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mlstm_chunk.kernel import (mlstm_chunk_fwd,
                                                    mlstm_chunk_plain)
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd, moe_gmm_plain
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_fwd,
                                                   rglru_scan_plain)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

pytestmark = pytest.mark.gpu

DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(arr, dev, dt="f32"):
    return torch.from_numpy(np.asarray(arr, np.float32)).to(dev).to(DT[dt])


def _close(got, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


#: bf16 attention outputs, (atol, rtol): one bf16 step (2^-7 of the value)
#: between two roundings of f32 results, 1e-3 absolute for outputs near 0
#: (chip_smoke.py's BF16_ATTN_TOL)
BF16_ATTN_TOL = (1e-3, 2.0 ** -7)


@pytest.mark.parametrize("B,H,Sq,Sk,d,causal,window,dt", [
    (1, 2, 200, 200, 64, True, None, "f32"),
    (2, 1, 130, 130, 120, False, None, "bf16"),
    (1, 2, 300, 300, 256, True, 100, "bf16"),
    (1, 1, 96, 96, 256, False, None, "f32"),
    (2, 2, 65, 65, 32, True, 7, "f32"),
    (1, 1, 64, 160, 128, False, 40, "f32"),
    # bf16, the wgmma/TMA kernel: every head-width build, q and kv tails
    # off the 64- and 128-row tiles, windows of 1 and 7, B * H > 1
    (1, 2, 200, 200, 32, True, None, "bf16"),
    (2, 2, 65, 65, 64, True, 7, "bf16"),
    (1, 3, 77, 77, 128, True, 1, "bf16"),
    (1, 1, 129, 129, 128, True, None, "bf16"),
    (1, 1, 64, 160, 128, False, 40, "bf16"),
    (2, 3, 190, 250, 64, False, None, "bf16"),
    (1, 2, 333, 333, 256, False, 7, "bf16"),
    (1, 2, 257, 257, 256, True, 1, "bf16"),
    (3, 1, 100, 70, 120, False, None, "bf16"),
])
def test_flash_attention_kernel_matches_plain(dev, B, H, Sq, Sk, d, causal,
                                              window, dt):
    rng = np.random.default_rng(0)
    q = _t(rng.normal(size=(B, H, Sq, d)), dev, dt)
    k, v = (_t(rng.normal(size=(B, H, Sk, d)), dev, dt) for _ in range(2))
    fa = flash_attention_fwd
    before = (fa.launches, fa.sm90_launches)
    got = fa(q, k, v, causal=causal, window=window)
    # bf16 goes to the wgmma/TMA kernel, f32 to the CUDA-core kernel
    assert (fa.launches, fa.sm90_launches) == \
        (before[0] + (dt == "f32"), before[1] + (dt == "bf16"))
    atol, rtol = BF16_ATTN_TOL if dt == "bf16" else (2e-5, 2e-5)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if Sq == Sk:
        want = attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


def test_flash_attention_bf16_refuses_what_tma_cannot_load(dev):
    q = torch.zeros((1, 1, 64, 100), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_fwd(q, q, q)
    buf = torch.zeros(1 * 1 * 64 * 64 + 1, dtype=torch.bfloat16, device=dev)
    odd = buf[1:].view(1, 1, 64, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_fwd(odd, odd, odd)


@pytest.mark.parametrize("E,C,D,F,bc,dt,zero_dead", [
    (4, 100, 72, 90, 128, "f32", True),
    (4, 200, 40, 130, 64, "bf16", True),
    (3, 256, 48, 64, 32, "f32", False),
])
def test_moe_gmm_kernel_matches_plain(dev, E, C, D, F, bc, dt, zero_dead):
    rng = np.random.default_rng(1)
    counts = np.array([0, 37, C, 70][:E], np.int32)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    if zero_dead:
        x[np.arange(C)[None, :] >= counts[:, None]] = 0.0
    x, w = _t(x, dev, dt), _t(rng.normal(size=(E, D, F)), dev, dt)
    c = torch.from_numpy(counts).to(dev)
    before = (moe_gmm_fwd.launches, moe_gmm_fwd.sm90_launches)
    got = moe_gmm_fwd(x, w, c, bc=bc)
    # f32, and bf16 with F = 130 (no TMA row stride), stay on moe_gmm.cu
    assert (moe_gmm_fwd.launches, moe_gmm_fwd.sm90_launches) == \
        (before[0] + 1, before[1])
    tol = 5e-2 if dt == "bf16" else 1e-4
    _close(got, moe_gmm_plain(x, w, c, bc=bc), tol)
    if zero_dead:
        _close(got, moe_gmm_ref(x, w, c), tol)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("E,C,D,F,bc,counts,zero_dead", [
    # C off the 128-row tile, a k tail (D = 72), F = 136 (a last column
    # tile of 8), counts of 0, 1, 127 and C
    (4, 200, 72, 136, 128, [0, 1, 127, 200], True),
    (3, 256, 64, 128, 32, [128, 129, 256], True),
    (2, 300, 40, 64, 64, [129, 300], True),
    (3, 200, 128, 256, 256, [1, 127, 200], True),
    # rows of a live tile past counts[e] are not zero: computed, not zeroed
    (2, 256, 72, 136, 64, [100, 37], False),
    # granite-moe-3b-a800m's expert widths
    (4, 1024, 1536, 512, 128, [0, 1024, 517, 129], True),
])
def test_moe_gmm_sm90_kernel_matches_plain(dev, E, C, D, F, bc, counts,
                                           zero_dead):
    rng = np.random.default_rng(5)
    counts = np.array(counts, np.int32)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    if zero_dead:
        x[np.arange(C)[None, :] >= counts[:, None]] = 0.0
    x = _t(x, dev, "bf16")
    w = _t(rng.normal(size=(E, D, F)) * D ** -0.5, dev, "bf16")
    c = torch.from_numpy(counts).to(dev)
    before = (moe_gmm_fwd.launches, moe_gmm_fwd.sm90_launches)
    got = moe_gmm_fwd(x, w, c, bc=bc)
    assert (moe_gmm_fwd.launches, moe_gmm_fwd.sm90_launches) == \
        (before[0], before[1] + 1)
    _close(got, moe_gmm_plain(x, w, c, bc=bc), 5e-2)
    if zero_dead:
        _close(got, moe_gmm_ref(x, w, c), 5e-2)
    rows = torch.arange(C, device=dev)[None, :]
    live = torch.clamp((c.long() + bc - 1) // bc * bc, max=C)[:, None]
    assert bool((got[rows >= live] == 0).all())
    if not zero_dead:
        past = (rows >= c[:, None]) & (rows < live)
        assert bool((got[past] != 0).any())


@pytest.mark.parametrize("B,S,D,dt", [(2, 300, 70, "f32"),
                                      (1, 257, 2560, "bf16")])
def test_rglru_scan_kernel_bit_equal_to_plain(dev, B, S, D, dt):
    rng = np.random.default_rng(2)
    a = _t(rng.uniform(0.7, 0.999, (B, S, D)), dev, dt)
    x = _t(rng.normal(size=(B, S, D)) * 0.1, dev, dt)
    h0 = _t(rng.normal(size=(B, D)) * 0.1, dev)
    h, hT = rglru_scan_fwd(a, x, h0)
    ph, phT = rglru_scan_plain(a, x, h0)
    torch.cuda.synchronize()
    assert torch.equal(h, ph) and torch.equal(hT, phT)
    rh, rhT = rglru_scan_ref(a, x, h0)
    assert torch.equal(h, rh) and torch.equal(hT, rhT)


@pytest.mark.parametrize("BH,S,dk,dv,bt,dt", [
    (2, 200, 40, 72, 32, "f32"),
    (1, 256, 64, 64, 64, "f32"),
    (3, 300, 96, 130, 128, "f32"),
    (1, 250, 33, 20, 100, "f32"),
    (2, 128, 64, 64, 128, "bf16"),
])
def test_mlstm_chunk_kernel_matches_plain(dev, BH, S, dk, dv, bt, dt):
    rng = np.random.default_rng(3)
    q, k = (_t(rng.normal(size=(BH, S, dk)) * 0.5, dev, dt)
            for _ in range(2))
    v = _t(rng.normal(size=(BH, S, dv)) * 0.5, dev, dt)
    lf = _t(np.log(rng.uniform(0.9, 0.999, (BH, S, 1))), dev)
    gi = _t(rng.uniform(0.1, 1.0, (BH, S, 1)), dev)
    y, c = mlstm_chunk_fwd(q, k, v, lf, gi, bt=bt)
    py, pc = mlstm_chunk_plain(q, k, v, lf, gi, bt=bt)
    tol = 3e-2 if dt == "bf16" else 2e-3
    _close(y, py, tol)
    _close(c, pc, tol)
    if dt == "f32":
        ry, rc = mlstm_chunk_ref(q, k, v, lf, gi)
        _close(y, ry, tol)
        _close(c, rc, tol)


def test_ops_gradients_on_the_card(dev):
    rng = np.random.default_rng(4)

    def leaves(*shapes):
        return [_t(rng.normal(size=s) * 0.5, dev).requires_grad_()
                for s in shapes]

    def check(op, ref, ins, extra=()):
        out = op(*ins, *extra)
        outs = out if isinstance(out, tuple) else (out,)
        got = torch.autograd.grad(sum((o ** 2).sum() for o in outs), ins)
        rout = ref(*ins, *extra)
        routs = rout if isinstance(rout, tuple) else (rout,)
        want = torch.autograd.grad(sum((o ** 2).sum() for o in routs), ins)
        for g, w in zip(got, want):
            _close(g, w, 1e-3)

    check(lambda q, k, v: flash_attention(q, k, v, True, None),
          lambda q, k, v: attention_ref(q, k, v, causal=True),
          leaves(*[(1, 2, 70, 64)] * 3))
    counts = torch.tensor([20, 64], dtype=torch.int32, device=dev)
    x, w = leaves((2, 64, 24), (2, 24, 40))
    with torch.no_grad():
        x[1:, 64:] = 0.0
        x[0, 20:] = 0.0
    check(lambda x, w: moe_gmm(x, w, counts),
          lambda x, w: moe_gmm_ref(x, w, counts), [x, w])
    a = _t(rng.uniform(0.7, 0.99, (1, 40, 16)), dev).requires_grad_()
    check(rglru_scan, rglru_scan_ref, [a] + leaves((1, 40, 16), (1, 16)))
    lf = _t(np.log(rng.uniform(0.9, 0.99, (2, 40, 1))), dev)
    gi = _t(rng.uniform(0.1, 1.0, (2, 40, 1)), dev)
    check(mlstm_chunk, mlstm_chunk_ref,
          leaves((2, 40, 8), (2, 40, 8), (2, 40, 8))
          + [lf.requires_grad_(), gi.requires_grad_()])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    f16 = torch.zeros((1, 1, 8, 8), dtype=torch.float16, device=dev)
    with pytest.raises(ValueError, match="float16"):
        flash_attention_fwd(f16, f16, f16)
    wide = torch.zeros((1, 1, 8, 264), device=dev)
    with pytest.raises(ValueError, match="d=264"):
        flash_attention_fwd(wide, wide, wide)
    x = torch.zeros((2, 8, 4), device=dev)
    with pytest.raises(ValueError, match="counts"):
        moe_gmm_fwd(x, torch.zeros((2, 4, 4), device=dev),
                    torch.zeros(2, dtype=torch.int64, device=dev))
    a = torch.zeros((1, 8, 4), device=dev)
    with pytest.raises(ValueError, match="non-contiguous"):
        rglru_scan_fwd(a.transpose(1, 2).contiguous().transpose(1, 2), a,
                       torch.zeros((1, 4), device=dev))
    q = torch.zeros((1, 8, 704), device=dev)
    g = torch.zeros((1, 8, 1), device=dev)
    with pytest.raises(ValueError, match="dk=704"):
        mlstm_chunk_fwd(q, q, q, g, g)
