"""The hand-written CUDA kernels of ``repro_torch.kernels`` on the card,
each held against its plain PyTorch version on the same card, at small and
uneven shapes that reach the kernels' edges: head widths that are not a
power of two, kv and q tails, windows, experts with no live row, rows
past the counts, partial chunks and every chunk build.  Both flash
attention kernels are here: f32 on the register-tiled CUDA-core kernel
(every head-width build, tails off its 128- and 64-row tiles, element
copies for unaligned rows), bf16 on wgmma/TMA (every head-width build,
held to one bf16 step); and both grouped matmul kernels: bf16 on
wgmma/TMA where TMA can load the rows, the CUDA-core kernel otherwise
(f32 and the other bf16), each case asserting by launch count which one
ran.  The domain the reference takes: bf16 flash attention that TMA
cannot load and heads wider than 256 (each on its build's launch count),
mLSTM chunks of 16 to 256 steps and keys of 8 to 704, float16 and
non-contiguous inputs to every op; and hetIR blocks of 1536 and 2048
lanes, several to a thread of the scalar segment kernels, bit-equal to
the interpreter.

Marked ``gpu``: without a CUDA device every test skips.  On a machine with
one (no jax needed), from the checkout root:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import HetSession, TranslationCache, edge_grids
from repro_torch.core import hetir as ir
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
    # f32, the register-tiled CUDA-core kernel: every head-width build (d
    # <= 64 and <= 128 on 128-row q tiles and 64-key tiles, d <= 256 on 64
    # and 32), q and kv tails off those tiles, Sq != Sk, windows of 1, 7
    # and one whose band edge crosses a kv tile, B * H > 1
    (1, 1, 127, 127, 32, True, None, "f32"),
    (2, 3, 129, 129, 64, True, None, "f32"),
    (1, 2, 257, 257, 120, True, 1, "f32"),
    (1, 1, 333, 333, 128, True, None, "f32"),
    (2, 2, 129, 129, 200, True, 7, "f32"),
    (1, 2, 333, 333, 256, True, 100, "f32"),
    (1, 1, 300, 300, 128, True, 70, "f32"),
    (1, 1, 257, 257, 256, False, 33, "f32"),
    (2, 1, 190, 250, 128, False, None, "f32"),
    (1, 2, 333, 129, 64, False, None, "f32"),
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


def _view_off_16_bytes(t):
    """``t``'s values in a tensor that starts 4 bytes past a 16-byte
    boundary: the kernels' element-by-element copies."""
    off = 4 // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


def _counts():
    fa = flash_attention_fwd
    return (fa.launches, fa.sm90_launches, fa.simt_bf16_launches,
            fa.wide_launches)


@pytest.mark.parametrize("d,unaligned,causal,window", [
    (4, False, True, None), (100, False, True, 33), (64, True, True, None),
    (100, True, False, 7)])
def test_flash_attention_bf16_tma_cannot_load_matches_plain(
        dev, d, unaligned, causal, window):
    # d % 8 != 0, or 4 bytes off a 16-byte boundary: the bf16 build of the
    # CUDA-core kernel, not the wgmma/TMA one
    rng = np.random.default_rng(8)
    q, k, v = (_t(rng.normal(size=(2, 2, 150, d)), dev, "bf16")
               for _ in range(3))
    if unaligned:
        q, k, v = (_view_off_16_bytes(t) for t in (q, k, v))
    before = _counts()
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert _counts() == (before[0], before[1], before[2] + 1, before[3])
    atol, rtol = BF16_ATTN_TOL
    for want in (flash_attention_plain(q, k, v, causal=causal,
                                       window=window),
                 attention_ref(q, k, v, causal=causal, window=window)):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("d,Sq,Sk,causal,window,dt", [
    (320, 200, 200, True, None, "f32"), (512, 130, 130, False, 40, "f32"),
    (320, 150, 150, True, 17, "bf16"), (300, 100, 170, False, None, "f32")])
def test_flash_attention_wide_heads_match_plain(dev, d, Sq, Sk, causal,
                                                window, dt):
    rng = np.random.default_rng(9)
    q = _t(rng.normal(size=(1, 2, Sq, d)), dev, dt)
    k, v = (_t(rng.normal(size=(1, 2, Sk, d)), dev, dt) for _ in range(2))
    before = _counts()
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert _counts() == before[:3] + (before[3] + 1,)
    atol, rtol = BF16_ATTN_TOL if dt == "bf16" else (2e-5, 2e-5)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("d,causal,window", [(61, True, None),
                                             (128, False, 7)])
def test_flash_attention_f32_element_copies_match_plain(dev, d, causal,
                                                        window):
    # d % 4 != 0 or an unaligned tensor: 4-byte cp.async copies and stores
    rng = np.random.default_rng(6)
    q, k, v = (_view_off_16_bytes(_t(rng.normal(size=(2, 1, 150, d)), dev))
               for _ in range(3))
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert flash_attention_fwd.launches == before + 1
    _close(got, flash_attention_plain(q, k, v, causal=causal,
                                      window=window), 2e-5)
    _close(got, attention_ref(q, k, v, causal=causal, window=window), 2e-5)


@pytest.mark.parametrize("E,C,D,F,bc,counts,dt,zero_dead,unaligned", [
    # C < 128; D off the 64-wide slice; F off the 128-column tile; bc of
    # 32, 48 and 128; counts 0, C and in between
    (3, 100, 72, 200, 32, [0, 100, 45], "f32", True, False),
    (4, 300, 36, 136, 48, [0, 300, 49, 144], "f32", True, False),
    (3, 256, 44, 64, 128, [1, 256, 129], "f32", True, False),
    (2, 200, 40, 130, 48, [70, 200], "f32", False, False),
    # several 64-wide slices of D, the last one partial
    (2, 130, 300, 72, 32, [64, 130], "f32", True, False),
    # element-by-element loads: D % 4 != 0, F % 4 != 0, unaligned x
    (2, 150, 33, 90, 32, [0, 97], "f32", True, False),
    (2, 130, 64, 64, 128, [5, 130], "f32", True, True),
    # bf16 that TMA cannot load (F % 8 != 0)
    (3, 150, 36, 90, 48, [0, 70, 150], "bf16", True, False),
])
def test_moe_gmm_cuda_core_tiles_match_plain(dev, E, C, D, F, bc, counts, dt,
                                             zero_dead, unaligned):
    rng = np.random.default_rng(7)
    counts = np.array(counts, np.int32)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    if zero_dead:
        x[np.arange(C)[None, :] >= counts[:, None]] = 0.0
    x = _t(x, dev, dt)
    if unaligned:
        x = _view_off_16_bytes(x)
    w = _t(rng.normal(size=(E, D, F)) * D ** -0.5, dev, dt)
    c = torch.from_numpy(counts).to(dev)
    before = (moe_gmm_fwd.launches, moe_gmm_fwd.sm90_launches)
    got = moe_gmm_fwd(x, w, c, bc=bc)
    assert (moe_gmm_fwd.launches, moe_gmm_fwd.sm90_launches) == \
        (before[0] + 1, before[1])
    tol = 5e-2 if dt == "bf16" else 1e-4
    _close(got, moe_gmm_plain(x, w, c, bc=bc), tol)
    if zero_dead:
        _close(got, moe_gmm_ref(x, w, c), tol)
    rows = torch.arange(C, device=dev)[None, :]
    live = torch.clamp((c.long() + bc - 1) // bc * bc, max=C)[:, None]
    assert bool((got[(rows >= live).expand(E, C)] == 0).all())
    if not zero_dead:   # rows past counts[e] in a live tile are computed
        past = (rows >= c[:, None]) & (rows < live)
        assert bool((got[past] != 0).any())


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


@pytest.mark.parametrize("B,S,D,dt,unaligned", [
    (2, 300, 70, "f32", False),
    (1, 257, 2560, "bf16", False),
    # S off the time tiles (128 steps of bf16, 64 of f32), D off the
    # 16-channel groups (whole 16-byte chunks, or element copies where a
    # row does not start on 16 bytes), B > 1, an unaligned tensor
    (2, 1000, 2568, "bf16", False),
    (3, 129, 37, "bf16", False),
    (2, 65, 100, "f32", False),
    (2, 200, 64, "f32", True),
    (1, 4096, 2560, "bf16", False),
])
def test_rglru_scan_kernel_bit_equal_to_plain(dev, B, S, D, dt, unaligned):
    rng = np.random.default_rng(2)
    a = _t(rng.uniform(0.7, 0.999, (B, S, D)), dev, dt)
    x = _t(rng.normal(size=(B, S, D)) * 0.1, dev, dt)
    h0 = _t(rng.normal(size=(B, D)) * 0.1, dev)
    if unaligned:
        a, x = _view_off_16_bytes(a), _view_off_16_bytes(x)
    before = rglru_scan_fwd.launches
    h, hT = rglru_scan_fwd(a, x, h0)
    assert rglru_scan_fwd.launches == before + 1
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
    # chunks of 16, 100 (a partial last chunk), 128 and 256 (run as two of
    # 128); dk of 8, 384 (one 384-row state tile) and 704 (two); dv off the
    # 32- and 128-column tiles; f32 and bf16
    (2, 70, 8, 36, 16, "f32"),
    (1, 333, 384, 100, 100, "f32"),
    (2, 300, 704, 40, 128, "f32"),
    (1, 600, 128, 64, 256, "f32"),
    (1, 250, 384, 132, 128, "bf16"),
    (1, 180, 704, 24, 256, "bf16"),
    (2, 90, 8, 8, 16, "bf16"),
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
    # what the reference refuses too: shapes that do not fit together,
    # empty dimensions, tensors on several devices
    q = torch.zeros((1, 1, 8, 16), device=dev)
    with pytest.raises(ValueError, match="k: got"):
        flash_attention_fwd(q, torch.zeros((1, 1, 8, 12), device=dev), q)
    x = torch.zeros((2, 0, 4), device=dev)
    with pytest.raises(ValueError, match="non-empty"):
        moe_gmm_fwd(x, torch.zeros((2, 4, 4), device=dev),
                    torch.zeros(2, dtype=torch.int32, device=dev))
    a = torch.zeros((1, 8, 4), device=dev)
    with pytest.raises(ValueError, match="several devices"):
        rglru_scan_fwd(a, a, torch.zeros((1, 4)))
    g = torch.zeros((1, 8, 2), device=dev)
    with pytest.raises(ValueError, match="lf: got"):
        mlstm_chunk_fwd(a, a, a, g, g)


def _f16_and_strided_calls(dev, rng):
    """One call of each wrapper on float16 tensors and on non-contiguous
    views (transposed copies), with the tolerance of the comparison: the
    kernel's in f32 and one float16 step (2^-10 of the value) between two
    roundings of f32 results."""
    def f16(*shape, scale=1.0, lo=None):
        a = rng.uniform(lo, 0.999, shape) if lo is not None \
            else rng.normal(size=shape) * scale
        return torch.from_numpy(a.astype(np.float32)).to(dev).half()

    def strided(t):   # the same values, last two dimensions' strides swapped
        return t.transpose(-1, -2).contiguous().transpose(-1, -2)

    q, k, v = (f16(1, 2, 90, 40) for _ in range(3))
    x, w = f16(3, 70, 24), f16(3, 24, 36, scale=0.2)
    counts = torch.tensor([0, 33, 70], device=dev)          # int64
    a, xr, h0 = f16(2, 50, 24, lo=0.7), f16(2, 50, 24, scale=0.1), \
        f16(2, 24, scale=0.1)
    mq, mk, mv = (f16(2, 70, 16, scale=0.5) for _ in range(3))
    lf = torch.log(f16(2, 70, 1, lo=0.9).float()).half()
    gi = f16(2, 70, 1, lo=0.1)
    tol = 2.0 ** -10
    return {
        "flash_attention": [
            (lambda fn: fn(q, k, v, causal=True, window=None), 2e-5 + tol),
            (lambda fn: fn(strided(q.float()), k.float(), strided(v.float()),
                           causal=True, window=None), 2e-5)],
        "moe_gmm": [
            (lambda fn: fn(x, w, counts), 1e-4 + tol),
            (lambda fn: fn(strided(x.float()), strided(w.float()), counts),
             1e-4)],
        "rglru_scan": [
            (lambda fn: fn(a, xr, h0), 0.0),
            (lambda fn: fn(strided(a.float()), xr.float(), h0.float()),
             0.0)],
        "mlstm_chunk": [
            (lambda fn: fn(mq, mk, mv, lf, gi, bt=32), 2e-3 + tol),
            (lambda fn: fn(strided(mq.float()), mk.float(),
                           strided(mv.float()), lf, gi, bt=32), 2e-3)],
    }


_FWD = {"flash_attention": (flash_attention_fwd, flash_attention_plain),
        "moe_gmm": (moe_gmm_fwd, moe_gmm_plain),
        "rglru_scan": (rglru_scan_fwd, rglru_scan_plain),
        "mlstm_chunk": (mlstm_chunk_fwd, mlstm_chunk_plain)}


@pytest.mark.parametrize("name", sorted(_FWD))
def test_wrappers_take_f16_and_non_contiguous_inputs(dev, name):
    # float16 computes in f32 and returns float16; a non-contiguous view
    # is copied; both launch the kernel and match the plain version
    fwd, plain = _FWD[name]
    for call, tol in _f16_and_strided_calls(
            dev, np.random.default_rng(12))[name]:
        before = sum(getattr(fwd, a) for a in dir(fwd)
                     if a.endswith("launches"))
        got = call(fwd)
        assert sum(getattr(fwd, a) for a in dir(fwd)
                   if a.endswith("launches")) == before + 1
        want = call(plain)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype
            torch.cuda.synchronize()
            if tol == 0:
                assert torch.equal(g, w)
            else:
                torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                           rtol=tol)


# ---------------------------------------------------------------------------
# hetIR blocks wider than 1024 lanes: several lanes to a thread of the
# scalar segment kernels
# ---------------------------------------------------------------------------

WIDE_CASES = [f"edge:{label}" for label, _ in edge_grids.wide_cases(32)] \
    + list(edge_grids.WIDE_SUITE)


def _wide_case(case, T):
    if case.startswith("edge:"):
        return dict(edge_grids.wide_cases(T))[case[5:]]
    return edge_grids.wide_suite_case(case, T)


def _het_run(backend, device, prog, grid, block, args, outs):
    s = HetSession(backend, opt_level=0, device=device,
                   cache=TranslationCache())
    fn = s.load(prog).function()
    bound = {p.name: s.alloc(int(args[p.name].size), p.dtype)
             .copy_from_host(args[p.name]) if isinstance(p, ir.Ptr)
             else args[p.name] for p in prog.params}
    rec = fn.launch_async(grid, block, bound)
    assert rec.wait()
    return s, {o: rec.buffer(o).copy_to_host() for o in outs}


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.float32:
        a = np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)
    return a


@pytest.mark.parametrize("T", [1536, 2048])
@pytest.mark.parametrize("case", WIDE_CASES)
def test_hetir_blocks_wider_than_1024_lanes_bit_equal_to_interp(dev, case,
                                                                 T):
    prog, grid, block, args, outs = _wide_case(case, T)
    s, got = _het_run("cuda", dev, prog, grid, block, args, outs)
    torch.cuda.synchronize()
    assert s.backend.launches["scalar"] > 0
    _, want = _het_run("interp", "cpu", prog, grid, block, args, outs)
    for o in outs:
        np.testing.assert_array_equal(_bits(got[o]), _bits(want[o]),
                                      err_msg=f"{case} T={T} {o}")
