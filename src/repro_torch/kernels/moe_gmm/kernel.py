"""Grouped (per-expert) matmul kernel — the MoE expert GEMM.

``x [E, C, D] @ w [E, D, F] -> [E, C, F]`` with a row-count vector
``counts [E]``: row tiles of ``bc`` rows that hold no live row (the first
row at or past ``counts[e]``) skip the product and stay zero (capacity
buckets are padded; dispatch guarantees rows >= counts are zero).

Port of ``src/repro/kernels/moe_gmm/kernel.py`` (``moe_gmm_fwd``).  Two
CUDA kernels, routed by type and shape before the launch; each reads
``counts[e]`` itself and computes exactly the rows of the live ``bc``-row
tiles, so each gives what the Pallas kernel gives for any ``bc``:

* bf16 whose rows TMA can load (``D`` and ``F`` multiples of 8, ``x`` and
  ``w`` 16-byte aligned): ``csrc/kernels/moe_gmm_sm90.cu``, one block per
  (expert, 128-row tile, 256-column tile): a producer warp loads the x and
  w tiles by TMA into a four-stage ring, two consumer warpgroups multiply
  with ``wgmma`` into f32 accumulators (the Pallas body's bf16 x bf16 ->
  f32 dot).  Launches counted in ``moe_gmm_fwd.sm90_launches``.
* f32, and bf16 that TMA cannot load: ``csrc/kernels/moe_gmm.cu``, a
  register-tiled GEMM on the CUDA cores in IEEE f32 (no TF32: f32 results
  are held to 1e-4) over ``csrc/kernels/simt_f32.cuh``: one 256-thread
  block per (expert, 128-row tile, 128-column tile), 8 x 8 outputs a
  thread, ``D`` in slices of 64 copied by ``cp.async`` into two stages
  (x and w row-major, read as float2 and float4), 132 KB of shared memory:
  one block per SM, with the registers that leaves it.  Launches counted
  in ``moe_gmm_fwd.launches``.

Any other floating type (float16, or operands of mixed types) computes in
f32 and returns the type of ``x``
(:func:`~repro_torch.kernels._cuda.prepare`).
"""
from __future__ import annotations

import torch

from .. import _cuda


def moe_gmm_plain(x, w, counts, *, bc: int = 128, bf: int = 128,
                  bd: int = 128):
    """The Pallas body in eager torch, experts side by side: for every
    (row tile, column tile) an f32 accumulator summed over ``bd``-wide
    contraction tiles, zero for the experts whose tile holds no live
    row."""
    E, C, D = x.shape
    F = w.shape[-1]
    bc, bf, bd = min(bc, C), min(bf, F), min(bd, D)
    counts = counts.to(x.device)
    out = torch.zeros((E, C, F), dtype=x.dtype, device=x.device)
    for c0 in range(0, C, bc):
        live = (c0 < counts)[:, None, None]
        for f0 in range(0, F, bf):
            acc = torch.zeros((E, min(bc, C - c0), min(bf, F - f0)),
                              dtype=torch.float32, device=x.device)
            for d0 in range(0, D, bd):
                acc += torch.bmm(x[:, c0:c0 + bc, d0:d0 + bd].float(),
                                 w[:, d0:d0 + bd, f0:f0 + bf].float())
            out[:, c0:c0 + bc, f0:f0 + bf] = torch.where(
                live, acc, torch.zeros_like(acc)).to(x.dtype)
    return out


def moe_gmm_fwd(x, w, counts, *, bc: int = 128, bf: int = 128,
                bd: int = 128):
    """x: [E,C,D]; w: [E,D,F] (floating point); counts: [E] (integer).
    Returns [E,C,F] in the type of ``x``.  On the card ``bf`` and ``bd`` (the
    Pallas output and contraction tiles) do not change the result and are
    not used; ``bc`` decides which rows are live."""
    if not _cuda.on_cuda(x, w, counts):
        return moe_gmm_plain(x, w, counts, bc=bc, bf=bf, bd=bd)
    out_dtype = x.dtype
    (x, w), _, (counts,) = _cuda.prepare((x, w), i32=(counts,))
    E, C, D = x.shape
    F = w.shape[-1]
    _cuda.require(x, "x", _cuda.FLOATS, (E, C, D))
    _cuda.require(w, "w", (x.dtype,), (E, D, F))
    _cuda.require(counts, "counts", (torch.int32,), (E,))
    if bc < 1:
        raise ValueError(f"bc={bc}: the row tile needs at least one row")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    P, I = _cuda.P, _cuda.I
    if tma_loadable(x, w):
        _cuda.launch("moe_gmm_sm90", [P, P, P, P, I, I, I, I, I], x.device,
                     x.data_ptr(), w.data_ptr(), counts.data_ptr(),
                     out.data_ptr(), E, C, D, F, min(bc, C))
        moe_gmm_fwd.sm90_launches += 1
        return out.to(out_dtype)
    _cuda.launch("moe_gmm", [P, P, P, P, I, I, I, I, I, I], x.device,
                 x.data_ptr(), w.data_ptr(), counts.data_ptr(),
                 out.data_ptr(), E, C, D, F, min(bc, C),
                 _cuda.DTYPE_CODE[x.dtype])
    moe_gmm_fwd.launches += 1
    return out.to(out_dtype)


def tma_loadable(x, w) -> bool:
    """Does ``moe_gmm_sm90`` take these inputs?  bf16, row strides in
    multiples of 16 bytes (``D`` and ``F`` multiples of 8) and 16-byte
    aligned tensors, as TMA loads them."""
    return x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0 \
        and w.shape[-1] % 8 == 0 \
        and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0


#: launches of the f32 / CUDA-core kernel and of the bf16 wgmma/TMA kernel
#: (the plain version launches nothing)
moe_gmm_fwd.launches = 0
moe_gmm_fwd.sm90_launches = 0
