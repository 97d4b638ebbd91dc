"""The mLSTM op's backward through the chunked oracle, held on the CPU.

``repro_torch.kernels.mlstm_chunk``'s backward recomputes through
``mlstm_chunk_chunked_ref`` (chunks of the forward's ``bt``, after the JAX
model's ``chunk_step``) instead of the per-step oracle.  Its gradients,
with a nonzero cotangent on the final state as well as on the outputs,
are held against autograd of the port's per-step oracle and against
``jax.vjp`` of the JAX package's ``mlstm_chunk_ref``, on the same numpy
inputs from a seed: ``B·H = 4``, ``S`` 64–256, 64 key and value columns
and the model's column of ones (``v`` padded to 68 columns), chunks of
16–64.  A backward that drops the state carried from one chunk to the
next must fail that comparison.  The bytes autograd saves in the
recompute (``saved_tensors_hooks``) must be at most a fifth of the
per-step oracle's, and double when ``S`` doubles at a fixed ``bt``: a
chunk's tensors, not a step's, which is what lets xlstm-125m's backward
at 2048 steps fit a card.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.ref import mlstm_chunk_ref as jax_mlstm_ref

from repro_torch.kernels.mlstm_chunk import mlstm_chunk, ops
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_chunked_ref,
                                                 mlstm_chunk_ref)
from repro_torch.models.layers import _ones_width

torch.set_num_threads(2)

BH, HV = 4, 64
#: f32 on every side, sums in another order: each gradient's largest
#: error within 1e-4 of its largest entry (measured about 1e-6)
GRAD_RTOL = 1e-4
CASES = [(64, 16), (128, 32), (256, 64)]


def _inputs(S: int, seed: int = 0):
    """q, k, v (with the column of ones), lf = log σ, gi = σ as the
    model's gates give them, and cotangents for y and the final state."""
    rng = np.random.default_rng(seed)
    dv = _ones_width(HV)
    q, k = (rng.normal(size=(BH, S, HV)).astype(np.float32) * 0.3
            for _ in range(2))
    v = np.zeros((BH, S, dv), np.float32)
    v[..., :HV] = rng.normal(size=(BH, S, HV))
    v[..., HV] = 1.0
    f, i = rng.normal(size=(2, BH, S, 1))
    lf = (-np.log1p(np.exp(-f))).astype(np.float32)
    gi = (1.0 / (1.0 + np.exp(-i))).astype(np.float32)
    dy = rng.normal(size=(BH, S, dv)).astype(np.float32)
    dc = rng.normal(size=(BH, HV, dv)).astype(np.float32)
    return [q, k, v, lf, gi], (dy, dc)


def _grads(fn, ins, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, c = fn(*ts)
    return [g.numpy() for g in torch.autograd.grad(
        (y, c), ts, [torch.from_numpy(t) for t in cot])]


def _worst(got, want) -> float:
    """The largest error over the five gradients, each relative to its
    largest entry."""
    return max(float(np.abs(g - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"S{c[0]}-bt{c[1]}")
def case(request):
    S, bt = request.param
    ins, cot = _inputs(S)
    _, vjp = jax.vjp(jax_mlstm_ref, *ins)
    want_jax = [np.asarray(g) for g in vjp(cot)]
    want_step = _grads(mlstm_chunk_ref, ins, cot)
    return bt, ins, cot, want_jax, want_step


def test_op_gradients_match_the_per_step_oracle_and_jax(case):
    bt, ins, cot, want_jax, want_step = case
    got = _grads(lambda *t: mlstm_chunk(*t, bt), ins, cot)
    assert _worst(got, want_step) <= GRAD_RTOL
    assert _worst(got, want_jax) <= GRAD_RTOL


def _state_dropped(q, k, v, lf, gi, bt=128):
    """The chunked oracle with each chunk started from an empty state:
    the state carried between chunks dropped."""
    S = q.shape[1]
    outs = [mlstm_chunk_chunked_ref(q[:, t0:t0 + bt], k[:, t0:t0 + bt],
                                    v[:, t0:t0 + bt], lf[:, t0:t0 + bt],
                                    gi[:, t0:t0 + bt], bt)
            for t0 in range(0, S, bt)]
    return torch.cat([y for y, _ in outs], 1), outs[-1][1]


def test_a_backward_that_drops_the_carried_state_fails(case, monkeypatch):
    bt, ins, cot, want_jax, want_step = case
    monkeypatch.setattr(ops, "mlstm_chunk_chunked_ref", _state_dropped)
    got = _grads(lambda *t: mlstm_chunk(*t, bt), ins, cot)
    assert _worst(got, want_jax) > 100 * GRAD_RTOL
    assert _worst(got, want_step) > 100 * GRAD_RTOL


def _saved_bytes(fn, ins) -> int:
    """Bytes of the tensors autograd saves in one recompute through
    ``fn``."""
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*ts)
    return total[0]


def test_the_recompute_saves_a_chunks_tensors_not_a_steps():
    bt = 64
    ins, _ = _inputs(256)
    per_step = _saved_bytes(mlstm_chunk_ref, ins)
    chunked = _saved_bytes(lambda *t: mlstm_chunk_chunked_ref(*t, bt), ins)
    assert chunked * 5 <= per_step, (chunked, per_step)
    longer, _ = _inputs(512)
    doubled = _saved_bytes(lambda *t: mlstm_chunk_chunked_ref(*t, bt),
                           longer)
    assert 1.9 <= doubled / chunked <= 2.1, (doubled, chunked)
