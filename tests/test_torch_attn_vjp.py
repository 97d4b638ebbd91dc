"""The flash attention op's ``"flash"`` backward, held on the CPU.

Under ``attn_vjp="flash"`` (the production profile,
``configs.get_optimized_config``) ``repro_torch.kernels.flash_attention``
takes its gradients chunk by chunk (``attention_chunked_bwd``: 512 query
rows at a time, each chunk's probabilities recomputed and differentiated
by the JAX model's equations before the next).  Held here:

* ``dq``, ``dk``, ``dv`` against ``jax.vjp`` of the JAX model's
  ``_mha_chunked`` (its custom VJP ``_mha_chunked_bwd``), on the same
  numpy inputs from a seed, ``[B, S, H, hd]`` on the JAX side and ``[B,
  H, S, hd]`` on the port's: causal at 1024 queries (two chunks), a
  window of 300, bidirectional, cross-attention of 1024 queries on 700
  keys, and one chunk of 300 queries;
* 1100 queries, which the JAX model refuses (more than one chunk and no
  multiple of 512) and the port runs with a last chunk of 76 rows,
  against the port's ``"autodiff"`` route;
* the backward's peak of live bytes (``launch.hlo_analysis.OpCounter``,
  which the dry run reads): under ``"flash"`` at most
  ``CHUNK_SCORES_BOUND`` times one chunk's ``[B, H, 512, Sk]`` f32
  scores, beside the inputs' and gradients' own bytes, and under
  ``"autodiff"`` past that bound at 2048 queries;
* the smoke llama3.2-3b trained in the production profile: loss and
  every gradient against ``jax.value_and_grad`` of the JAX model's
  ``forward_train`` under its own production profile, weights carried by
  ``params_from_jax``, over 1024 positions (two chunks).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models.layers import _mha_chunked

from repro_torch import configs
from repro_torch.kernels import flash_attention
from repro_torch.launch.hlo_analysis import OpCounter
from repro_torch.models import Model, params_from_jax, params_to_jax

torch.set_num_threads(2)

B, H, D = 1, 2, 16
#: f32 on both sides, the same equations with sums in another order (and
#: the port's keys trimmed to those a chunk can see): each gradient's
#: largest error within 1e-5 of its largest entry (measured 2e-7 to 7e-7)
GRAD_RTOL = 1e-5
#: the model case, as tests/test_torch_train.py holds a train step
LOSS_ATOL, MODEL_GRAD_RTOL = 1e-5, 1e-4
#: the "flash" backward's live bytes: a chunk's scores, probabilities
#: and a product of the two (3 chunks at most), under this multiple
CHUNK_SCORES_BOUND = 4
#: (Sq, Sk, causal, window)
CASES = {"causal-1024": (1024, 1024, True, None),
         "window-300": (1024, 1024, True, 300),
         "bidirectional": (1024, 1024, False, None),
         "cross-1024x700": (1024, 700, False, None),
         "one-chunk-300": (300, 300, True, None)}


def _inputs(Sq, Sk, seed=0):
    """q, k, v and the cotangent, ``[B, S, H, hd]`` f32 (the JAX
    layout)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, H, D)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    return q, k, v, do


def _heads_first(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))


def _port_grads(q, k, v, do, causal, window, vjp):
    """The op's ``dq, dk, dv`` back in the JAX layout."""
    ts = [_heads_first(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*ts, causal, window, vjp=vjp)
    grads = torch.autograd.grad(o, ts, _heads_first(do))
    return [g.numpy().transpose(0, 2, 1, 3) for g in grads]


def _worst(got, want) -> float:
    return max(float(np.abs(g - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("name", CASES)
def test_flash_backward_matches_jax_mha_chunked(name):
    Sq, Sk, causal, window = CASES[name]
    q, k, v, do = _inputs(Sq, Sk)
    _, vjp = jax.vjp(lambda q, k, v: _mha_chunked(q, k, v, causal, window),
                     q, k, v)
    want = [np.asarray(g) for g in vjp(do)]
    got = _port_grads(q, k, v, do, causal, window, "flash")
    assert _worst(got, want) <= GRAD_RTOL


def test_ragged_chunks_match_the_autodiff_route():
    """1100 queries: chunks of 512, 512 and 76 rows."""
    q, k, v, do = _inputs(1100, 1100)
    want = _port_grads(q, k, v, do, True, None, "autodiff")
    got = _port_grads(q, k, v, do, True, None, "flash")
    assert _worst(got, want) <= GRAD_RTOL


def test_an_unknown_route_is_refused():
    q = torch.zeros((1, 1, 4, 8))
    with pytest.raises(ValueError, match="attn_vjp"):
        flash_attention(q, q, q, vjp="chunked")


def _backward_peak(vjp: str, S: int) -> tuple:
    """(peak live bytes of the backward beyond its inputs', the bytes of
    one chunk's ``[B, H, 512, S]`` f32 scores, the bytes of one of ``q,
    k, v``)."""
    q, k, v, do = (_heads_first(a) for a in _inputs(S, S))
    ts = [t.requires_grad_() for t in (q, k, v)]
    o = flash_attention(*ts, True, None, vjp=vjp)
    counter = OpCounter()
    with counter:
        torch.autograd.grad(o, ts, do)
    return counter.peak_bytes, B * H * 512 * S * 4, q.numel() * 4


@pytest.mark.parametrize("S", [1024, 2048])
def test_flash_backward_keeps_a_chunks_scores(S):
    peak, chunk, qkv = _backward_peak("flash", S)
    # beside the scores: dq, dk, dv and a chunk's q and do rows
    assert peak <= CHUNK_SCORES_BOUND * chunk + 8 * qkv, (peak, chunk)


def test_autodiff_backward_exceeds_the_chunk_bound():
    peak, chunk, qkv = _backward_peak("autodiff", 2048)
    assert peak > CHUNK_SCORES_BOUND * chunk + 8 * qkv, (peak, chunk)


def test_llama_trains_in_the_production_profile_like_jax():
    arch = "llama3.2-3b"
    ref_cfg = ref_configs.get_optimized_smoke_config(arch)
    cfg = configs.get_optimized_smoke_config(arch)
    assert (ref_cfg.attn_vjp, cfg.attn_vjp) == ("flash", "flash")
    tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jax_init_params, cfg=ref_cfg))(jax.random.key(0)))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 1024))
             .astype(np.int32)}
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jax_forward_train, cfg=ref_cfg)))(
            tree, {n: jnp.asarray(a) for n, a in batch.items()})
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    got = model.forward_train({n: torch.from_numpy(a)
                               for n, a in batch.items()})
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= LOSS_ATOL
    got_grads = params_to_jax({n: p.grad for n, p in
                               model.named_parameters()}, cfg)
    want = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    have = dict(jax.tree_util.tree_flatten_with_path(got_grads)[0])
    assert sorted(map(str, have)) == sorted(map(str, want))
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        g = have[path].numpy().astype(np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= MODEL_GRAD_RTOL, (jax.tree_util.keystr(path), err)
