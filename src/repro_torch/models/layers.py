"""Model primitives of the serving and training paths: norms, RoPE, GQA
attention (causal, windowed or bidirectional prefill, one-token decode,
and cross-attention on an encoder's k/v), SwiGLU/GELU FFN, the sort-based
MoE and its load-balancing loss, and the recurrent mixers RG-LRU, mLSTM
and sLSTM.  Port of ``src/repro/models/layers.py`` for the block kinds
``ATTN``/``SWA``/``RGLRU``/``MLSTM``/``SLSTM`` + ``DENSE_FFN``/``MOE_FFN``,
with or without cross-attention.

Every function is a plain function over tensors and a parameter mapping
``p`` (name -> tensor, in the JAX package's layouts: ``x @ p["wq"]``); the
``nn.Module`` owners live in :mod:`repro_torch.models.model`.  Four
products go through the port's hand-written kernels, by their public ops:

* the prefill's self-attention core (causal, windowed, or bidirectional
  in an encoder) and every cross-attention core, in the prefill and in
  each decode step: :func:`repro_torch.kernels.flash_attention` on
  ``[B, H, S, d]`` with kv repeated to ``H`` heads, ``Sq != Sk`` for
  cross-attention (on the card the wgmma/TMA kernel for bf16, the
  CUDA-core kernel for f32; on CPU tensors the plain version);
* every expert product of the MoE: :func:`repro_torch.kernels.moe_gmm` on
  the capacity buffer ``[E, C, D] @ [E, D, F]`` with ``counts[e]`` the rows
  kept for expert ``e``;
* the RG-LRU recurrence ``h = a·h + b·u``, prefill and decode alike:
  :func:`repro_torch.kernels.rglru_scan` on ``[B, S, d_rnn]`` f32;
* the chunked mLSTM (``mlstm_impl="chunked"``, ``S > 1``):
  :func:`repro_torch.kernels.mlstm_chunk` on ``[B·H, S, hd]``, its
  normalizer carried by a column of ones in ``v`` (:func:`mlstm_chunked`).

The decode's self-attention against the cache, the per-step mLSTM and
the sLSTM stay plain torch ops: the JAX package computes them outside any
Pallas kernel (the attention kernel assumes aligned q and k positions;
cross-attention has no positions to align, so its decode runs the kernel).

The split over a mesh's ``model`` dim.  Every mixer and FFN takes the
reference's ``ac`` hook: None on one device (the one-device path, op for
op), or a :class:`~repro_torch.parallel.split.ModelSplit`, and then ``p``
holds this rank's blocks of the ``model``-split parameters.  At the
reference's points: ``ac(x, "mm_input")`` gathers a sequence-split
residual; ``heads4`` takes this rank's heads (:func:`_heads`,
:func:`_kv_for`: a projection whose columns do not line up with heads is
gathered first, as GSPMD reshards it, and a head count that the split
does not divide keeps every head on every rank); ``attn_mix`` /
``ffn_hidden`` end in a row-parallel product whose partial sums are added
over ``model`` (:func:`_row_parallel`); ``moe_buf`` runs this rank's
experts, or its slice of ``d_ff`` (:func:`_experts_of`), on its slice of
the capacity where the rule splits it over the fsdp axes
(:func:`moe_ffn_global`; the grouped dispatch keeps each row on its
rank); the mLSTM runs this rank's heads, or its block of one head's
value columns, and the sLSTM its heads (:func:`_split_mixer`), each with
``w_o`` row-parallel.  The decode reads a cache split by heads, by slots
(a log-sum-exp over ``model``) or whole.  Each split computation that the
mixers and the MoE run is a *share* function of the rank's index and the
split's size (:func:`moe_capacity_share`, :func:`moe_grouped_share`,
:func:`mlstm_scan_share`, :func:`mlstm_chunked_share`,
:func:`slstm_share`): the mesh path calls it with its own index, and a
harness with one card can call it for every index and assemble the
shares as the collectives do.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import MLSTM, SLSTM, ModelConfig
from ..kernels import flash_attention, mlstm_chunk, moe_gmm, rglru_scan

Params = Mapping[str, torch.Tensor]

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def normal(shape, scale: float, dtype: torch.dtype, device: torch.device,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in f32 from ``generator`` and cast to
    ``dtype`` (the JAX inits' ``normal(key, shape, dtype) * s``); on the
    ``meta`` device an empty tensor of that shape (parameter counts)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=generator, device=device)
            * scale).to(dtype)


def init_norm(cfg: ModelConfig, dtype, device) -> Dict[str, torch.Tensor]:
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros(cfg.d_model, dtype=dtype, device=device)}
    return {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device),
            "bias": torch.zeros(cfg.d_model, dtype=dtype, device=device)}


def init_attention(cfg: ModelConfig, dtype, device, generator
                   ) -> Dict[str, torch.Tensor]:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    return {name: normal(shape, s, dtype, device, generator)
            for name, shape in (("wq", (d, h * hd)), ("wk", (d, hkv * hd)),
                                ("wv", (d, hkv * hd)), ("wo", (h * hd, d)))}


def init_ffn(cfg: ModelConfig, dtype, device, generator
             ) -> Dict[str, torch.Tensor]:
    d, d_ff = cfg.d_model, cfg.d_ff
    s, s_ff = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    if cfg.act == "swiglu":
        return {"wg": normal((d, d_ff), s, dtype, device, generator),
                "wu": normal((d, d_ff), s, dtype, device, generator),
                "wd": normal((d_ff, d), s_ff, dtype, device, generator)}
    return {"w1": normal((d, d_ff), s, dtype, device, generator),
            "w2": normal((d_ff, d), s_ff, dtype, device, generator)}


def init_moe(cfg: ModelConfig, dtype, device, generator
             ) -> Dict[str, torch.Tensor]:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    s, s_f = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": normal((d, e), s, dtype, device, generator)}
    if cfg.act == "swiglu":
        p["wg"] = normal((e, d, f), s, dtype, device, generator)
        p["wu"] = normal((e, d, f), s, dtype, device, generator)
        p["wd"] = normal((e, f, d), s_f, dtype, device, generator)
    else:
        p["w1"] = normal((e, d, f), s, dtype, device, generator)
        p["w2"] = normal((e, f, d), s_f, dtype, device, generator)
    return p


def wide(dtype: torch.dtype) -> torch.dtype:
    """The type the layers' f32 math runs in for inputs of ``dtype``:
    float32, or float64 for float64 inputs (a model run in f64, the
    witness of the f32 model's rounding)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def f32up(t: torch.Tensor) -> torch.Tensor:
    """``t`` in :func:`wide`'s type: ``t.float()``, an f64 tensor kept."""
    return t.to(wide(t.dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    xf = f32up(x)
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + f32up(scale))).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = f32up(x)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def apply_norm(x, p: Params, cfg: ModelConfig):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S].  Half-split rotation
    (not interleaved), angles in f32."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freq          # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def repeat_kv(k, n_heads: int):
    """[B,S,Hkv,hd] -> [B,S,H,hd] (GQA repeat; h = kv*G + g)."""
    G = n_heads // k.shape[2]
    return k.repeat_interleave(G, dim=2) if G > 1 else k


def _mm_input(ac, x):
    return x if ac is None else ac(x, "mm_input")


def _heads(ac, t, n: int, hd: int):
    """A projection's output ``[B, S, c]`` as heads ``[B, S, h, hd]``: all
    ``n`` of them, or this rank's ``n / ac.n`` where its columns are
    split and line up with heads; split columns that do not line up (a
    fraction of a head per rank) are gathered whole first."""
    B, S, c = t.shape
    if ac is not None and c < n * hd and n % ac.n:
        t = ac.gather(t, 2)
    return t.reshape(B, S, -1, hd)


def _kv_for(ac, k, q_heads: int, n_heads: int, n_kv: int, dim: int = 2):
    """Keys or values ``k`` (all ``n_kv`` heads, or this rank's block of
    them, along ``dim``) for this rank's ``q_heads`` query heads (all
    ``n_heads``, or its block): repeated GQA-wise, or, from every kv head,
    the ones those queries read."""
    if ac is not None and q_heads < n_heads and k.shape[dim] == n_kv:
        G = n_heads // n_kv
        idx = (ac.index * q_heads
               + torch.arange(q_heads, device=k.device)) // G
        return k.index_select(dim, idx)
    G = q_heads // k.shape[dim]
    return k.repeat_interleave(G, dim=dim) if G > 1 else k


def _row_parallel(ac, o, w, rows: int):
    """``o @ w`` for ``w`` of ``rows`` rows (the reference's ``attn_mix``
    / ``ffn_hidden`` point): where ``w``'s rows are split, this rank's
    columns of ``o`` times its rows, the partial sums added over ``model``
    (:meth:`~repro_torch.parallel.split.ModelSplit.sum_seq`); else the
    whole product (under SP, this rank's slice of the sequence)."""
    if ac is None:
        return o @ w
    if w.shape[0] < rows:
        if o.shape[-1] == rows:
            o = ac.own(o, -1)
        return ac.sum_seq(o @ w)
    if o.shape[-1] < rows:
        o = ac.gather(o, -1)
    y = o @ w
    return ac.own(y, 1) if ac.seq else y


def attention(x, p: Params, cfg: ModelConfig, *, causal: bool = True,
              window: Optional[int] = None, positions=None, ac=None):
    """Self-attention over x [B,S,D]: causal (windowed when ``window``),
    or bidirectional with ``causal=False`` (an encoder; RoPE on q and k
    all the same); the core runs on the flash attention kernel (on a split
    mesh, on this rank's heads), its backward as ``cfg.attn_vjp`` says
    (``"flash"``: chunks of 512 query rows).  Returns ``(y, k, v)`` with
    the rotated keys and the values ``[B,S,Hkv,hd]`` that the cache keeps
    (this rank's kv heads where they are split; the JAX prefill projects
    them a second time)."""
    x = _mm_input(ac, x)
    B, S, D = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _heads(ac, x @ p["wq"], h, hd)
    k = _heads(ac, x @ p["wk"], hkv, hd)
    v = _heads(ac, x @ p["wv"], hkv, hd)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    hq = q.shape[2]
    o = flash_attention(q.transpose(1, 2),
                        _kv_for(ac, k, hq, h, hkv).transpose(1, 2),
                        _kv_for(ac, v, hq, h, hkv).transpose(1, 2), causal,
                        window, vjp=cfg.attn_vjp)           # [B,H,S,hd]
    y = _row_parallel(ac, o.transpose(1, 2).reshape(B, S, hq * hd),
                      p["wo"], h * hd)
    return y, k, v


def cross_kv(enc_out, p: Params, cfg: ModelConfig, ac=None):
    """The cross-attention keys and values of an encoder's output
    ``[B, S_enc, D]`` (whole): head-major ``[B, Hkv, S_enc, hd]`` (this
    rank's kv heads where they are split) and contiguous, as the cross
    cache keeps them (the JAX package keeps ``[B, S_enc, Hkv, hd]``), so
    that every decode step's kernel call reads them with no copy."""
    B, S, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    k = _heads(ac, enc_out @ p["wk"], hkv, hd)
    v = _heads(ac, enc_out @ p["wv"], hkv, hd)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def cross_attention(x, p: Params, cfg: ModelConfig, k, v, ac=None,
                    kv_split: Optional[int] = None):
    """Cross-attention of x [B,S,D] on an encoder's ``k, v [B, Hkv, S_enc,
    hd]`` (:func:`cross_kv`): no RoPE and no mask, as the JAX package's
    ``attention(kv_override=...)``; the core runs on the flash attention
    kernel with ``Sq = S`` (the prompt in the prefill, 1 in a decode
    step) against ``Sk = S_enc``.  ``kv_split``: the dim of ``k``/``v``
    split over ``model`` (1: heads, 2: encoder positions, whose partial
    attentions are combined by a log-sum-exp; None: whole)."""
    x = _mm_input(ac, x)
    B, S, D = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _heads(ac, x @ p["wq"], h, hd)
    if kv_split == 2:  # every head against this rank's encoder positions
        if q.shape[2] < h:
            q = ac.gather(q, 2)
        o = _attend_slots(ac, q, k.transpose(1, 2), v.transpose(1, 2), h,
                          None)
        return _row_parallel(ac, o, p["wo"], h * hd)
    q = q.transpose(1, 2)
    hq = q.shape[1]
    if ac is None:
        G = h // k.shape[1]
        if G > 1:
            k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    else:
        k, v = (_kv_for(ac, t, hq, h, hkv, dim=1) for t in (k, v))
    o = flash_attention(q, k, v, False, None,
                        vjp=cfg.attn_vjp)                   # [B,H,S,hd]
    return _row_parallel(ac, o.transpose(1, 2).reshape(B, S, hq * hd),
                         p["wo"], h * hd)


def _attend_slots(ac, q, k, v, h: int, valid):
    """One query position of every head ``q [B, 1, H, hd]`` against this
    rank's slice of the keys and values ``[B, Sl, Hkv, hd]`` (``valid``:
    their mask ``[Sl]``, or None), each rank's partial softmax combined
    over ``model`` by a log-sum-exp; returns ``[B, 1, H * hd]`` in ``q``'s
    type."""
    B, _, _, hd = q.shape
    hkv = k.shape[2]
    G = h // hkv
    qh = q.reshape(B, 1, hkv, G, hd)
    s = torch.einsum("bckgh,bskh->bkgcs", qh.float(), k.float()) \
        / math.sqrt(hd)
    if valid is not None:
        s = torch.where(valid, s, -torch.inf)
    m = ac.max(torch.clamp(s.amax(-1, keepdim=True), min=-1e30))
    pbar = torch.exp(s - m)
    l = ac.sum(pbar.sum(-1, keepdim=True))
    o = ac.sum(torch.einsum("bkgcs,bskh->bckgh", pbar, v.float()))
    o = o / torch.clamp(l.permute(0, 3, 1, 2, 4), min=1e-30)
    return o.reshape(B, 1, h * hd).to(q.dtype)


def attention_decode(x, p: Params, cfg: ModelConfig, cache, pos: int, *,
                     window: Optional[int] = None, ac=None,
                     kv_split: Optional[int] = None):
    """One-token decode against a cache.

    cache: {"k","v": [B, S_cache, Hkv, hd]} — a ring buffer when windowed
    (slot ``pos % S_cache``).  pos: absolute position of the new token.
    The new k/v are written into ``cache`` in place (the JAX package
    returns an updated copy); returns (y [B,1,D], cache).  On a split
    mesh ``kv_split`` says how this rank's cache is cut: 2, its kv heads
    (this rank's query heads read them); 1, its slice of the slots (every
    head, a log-sum-exp over ``model``; the slot's owner writes the new
    k/v); None, whole (this rank's query heads read the kv heads they
    need)."""
    B, S, D = x.shape  # S == 1
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _heads(ac, x @ p["wq"], h, hd)
    k_new = _heads(ac, x @ p["wk"], hkv, hd)
    v_new = _heads(ac, x @ p["wv"], hkv, hd)
    posv = torch.full((B, 1), pos, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k_new = rope(k_new, posv, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    if ac is not None and kv_split != 2 and k_new.shape[2] < hkv:
        k_new, v_new = ac.gather(k_new, 2), ac.gather(v_new, 2)
    S_cache = k.shape[1] * (ac.n if kv_split == 1 else 1)
    if window is None and pos >= S_cache:
        raise ValueError(f"position {pos} is past the cache of {S_cache}")
    slot = pos % S_cache if window is not None else pos
    idx = torch.arange(S_cache, device=x.device)
    if kv_split == 1:  # this rank's slots
        first = ac.index * k.shape[1]
        idx = idx[first:first + k.shape[1]]
        slot -= first
    if 0 <= slot < k.shape[1]:
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)

    if window is not None:
        # ring buffer: slot i holds position pos - ((pos - i) mod S_cache)
        kpos = pos - ((pos - idx) % S_cache)
        valid = (kpos >= 0) & (kpos >= pos - window + 1) & (kpos <= pos)
    else:
        valid = idx <= pos

    if kv_split == 1:
        if q.shape[2] < h:
            q = ac.gather(q, 2)
        return _row_parallel(ac, _attend_slots(ac, q, k, v, h, valid),
                             p["wo"], h * hd), cache
    hq = q.shape[2]
    if hq < h and k.shape[2] == hkv:  # this rank's heads, every kv head
        k, v = (_kv_for(ac, t, hq, h, hkv) for t in (k, v))
    scale = 1.0 / math.sqrt(hd)
    hk = k.shape[2]
    G = hq // hk
    qh = q.reshape(B, 1, hk, G, hd)
    s = torch.einsum("bckgh,bskh->bkgcs", qh.float(), k.float()) * scale
    s = torch.where(valid, s, -torch.inf)
    m = torch.clamp(s.amax(-1, keepdim=True), min=-1e30)
    pbar = torch.exp(s - m)
    l = pbar.sum(-1, keepdim=True)
    o = torch.einsum("bkgcs,bskh->bckgh", pbar / torch.clamp(l, min=1e-30),
                     v.float())
    o = o.reshape(B, 1, hq * hd).to(x.dtype)
    return _row_parallel(ac, o, p["wo"], h * hd), cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def ffn(x, p: Params, cfg: ModelConfig, ac=None):
    """The dense FFN; on a split mesh column-parallel in, row-parallel
    out."""
    x = _mm_input(ac, x)
    if cfg.act == "swiglu":
        return _row_parallel(ac, F.silu(x @ p["wg"]) * (x @ p["wu"]),
                             p["wd"], cfg.d_ff)
    return _row_parallel(ac, _gelu(x @ p["w1"]), p["w2"], cfg.d_ff)


# ---------------------------------------------------------------------------
# MoE (sort-based capacity dispatch)
# ---------------------------------------------------------------------------


def moe_ffn(x, p: Params, cfg: ModelConfig, ac=None, rows=None):
    """The MoE over ``x`` (its sequence already gathered on a split mesh:
    the caller's ``mm_input``); on a mesh ``rows`` is the executor's
    :class:`~repro_torch.parallel.split.MoERows` (the global dispatch's
    rows and capacity split)."""
    if cfg.moe_impl == "grouped":
        return moe_ffn_grouped(x, p, cfg, ac)
    return moe_ffn_global(x, p, cfg, ac, rows)


def topk(logits, K: int):
    """The top ``K`` of ``logits [..., E]`` along the last dimension,
    highest first, ties ranked lower index first, as ``lax.top_k`` ranks
    them: the first ``K`` of a stable descending sort (``torch.topk``
    ranks ties otherwise, and bf16 router logits do tie).  Returns
    (values, indices)."""
    values, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :K], idx[..., :K]


class Routing(NamedTuple):
    """Top-k routing of ``T`` tokens to ``E`` experts, ``N = T * K``
    entries sorted stably by expert (``[...]``: the grouped dispatch's
    batch rows): the softmaxed ``gates [..., T, K]``, the sort ``order
    [..., N]`` (entry ``order[i]`` is token ``order[i] // K``'s), each
    sorted entry's expert ``sorted_e`` and ``rank`` within its expert,
    each expert's first sorted entry ``starts [..., E]`` and its rows kept,
    ``counts [..., E]`` (``min(routed, C)``)."""
    gates: torch.Tensor
    order: torch.Tensor
    sorted_e: torch.Tensor
    rank: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor


def _route(logits, K: int, E: int, C: int) -> Routing:
    """Top-k routing with a stable sort by expert, as the JAX dispatch
    computes it, over the last two dimensions of ``logits [..., T, E]``.
    The experts are :func:`topk`'s, so tied logits pick the experts
    ``lax.top_k`` picks.  Nothing here waits for the device."""
    gates, idx = topk(logits, K)
    gates = torch.softmax(gates, dim=-1)
    flat_e = idx.reshape(*idx.shape[:-2], -1)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(E, device=logits.device).expand(
        *sorted_e.shape[:-1], E).contiguous()
    starts = torch.searchsorted(sorted_e, experts)
    ends = torch.searchsorted(sorted_e, experts, right=True)
    rank = torch.arange(sorted_e.shape[-1], device=logits.device) \
        - torch.gather(starts, -1, sorted_e)
    return Routing(gates, order, sorted_e, rank, starts,
                   (ends - starts).clamp(max=C))


def _dispatch(x, r: Routing, K: int, e0: int, El: int, c0: int, Cl: int):
    """The capacity buffer's rows ``[c0, c0 + Cl)`` of experts ``[e0, e0 +
    El)``, ``[..., El, Cl, D]``, from the tokens' rows ``x [..., T, D]``:
    row ``j`` of expert ``e`` holds the token of the ``(c0 + j)``-th entry
    routed to ``e``, and zeros from that slice's count of kept rows on
    (``clamp(counts[e] - c0, 0, Cl)``, returned too).  On one device
    ``c0 = 0`` and ``Cl = C``: the reference's buffer."""
    N = r.order.shape[-1]
    counts = (r.counts[..., e0:e0 + El] - c0).clamp(0, Cl)     # [..., El]
    j = torch.arange(Cl, device=x.device)
    pos = (r.starts[..., e0:e0 + El, None] + c0 + j).clamp(max=N - 1)
    tok = torch.gather(r.order, -1, pos.flatten(-2)) // K       # [..., El*Cl]
    # indexing, not gather: its backward accumulates with the card's
    # deterministic index_put (gather's scatter_add adds atomically)
    lead = tuple(torch.arange(n, device=x.device).reshape(
        n, *(1,) * (tok.dim() - 1 - i)) for i, n in enumerate(tok.shape[:-1]))
    rows = x[lead + (tok,)]                                     # [..., El*Cl, D]
    live = (j < counts[..., None])[..., None]                  # [..., El,Cl,1]
    return torch.where(live, rows.reshape(live.shape[:-1] + x.shape[-1:]),
                       0.0).to(x.dtype), counts


def _combine(out_buf, r: Routing, K: int, C: int, own=None):
    """Each token's output: the sum of its ``K`` contributions, its gates
    times the expert outputs ``out_buf [..., E, C, D]`` at its kept
    entries (zero where dropped); for tokens ``[t0, t0 + n)`` only where
    ``own = (t0, n)``.  The reference scatter-adds the contributions into
    zeros in sorted-entry order, that is by expert ascending; so do these
    adds, one after another in ``out_buf``'s type, with no atomics: the
    same bits on every run.  Returns ``[..., T or n, D]``."""
    # each token's K sorted positions, ascending (by expert): a stable
    # sort by token
    where = torch.sort(r.order // K, dim=-1, stable=True).indices
    if own is not None:
        where = where[..., own[0] * K:(own[0] + own[1]) * K]
    e = torch.gather(r.sorted_e, -1, where)
    rank = torch.gather(r.rank, -1, where)
    keep = rank < C
    w = torch.gather(r.gates.flatten(-2), -1,
                     torch.gather(r.order, -1, where)) * keep.to(r.gates.dtype)
    lead = tuple(torch.arange(n, device=where.device).reshape(
        n, *(1,) * (where.dim() - 1 - i))
        for i, n in enumerate(where.shape[:-1]))
    parts = out_buf[lead + (e, torch.where(keep, rank, 0))] \
        * w[..., None].to(out_buf.dtype)
    parts = parts.reshape(*where.shape[:-1], -1, K, out_buf.shape[-1])
    out = torch.zeros_like(parts[..., 0, :])
    for k in range(K):
        out = out + parts[..., k, :]
    return out


def _expert_products(buf, p: Params, cfg: ModelConfig, counts):
    """The experts' FFN on their capacity buffer ``[E, C, D]``: each
    product on the grouped matmul kernel, rows past ``counts[e]`` dead."""
    if cfg.act == "swiglu":
        h = F.silu(moe_gmm(buf, p["wg"], counts)) \
            * moe_gmm(buf, p["wu"], counts)
        return moe_gmm(h, p["wd"], counts)
    return moe_gmm(_gelu(moe_gmm(buf, p["w1"], counts)), p["w2"], counts)


def _experts_of(ac, p: Params, cfg: ModelConfig):
    """(first expert, expert count, whether ``d_ff`` is split) of this
    rank's expert weights: all experts whole on one device; on a split
    mesh its block of the experts (EP) or of every expert's ``d_ff``
    (expert-TP), as the rules place them."""
    w_out = p["wd"] if cfg.act == "swiglu" else p["w2"]
    E_local = w_out.shape[0]
    first = 0 if ac is None or E_local == cfg.moe.n_experts \
        else ac.index * E_local
    return first, E_local, w_out.shape[1] < cfg.moe.d_ff_expert


def _expert_outputs(ac, outs, E: int, f_split: bool, dim: int):
    """This rank's expert outputs (``outs``, its experts along ``dim``)
    made every expert's: gathered over the ranks (EP), or its ``d_ff``
    partial sums added (expert-TP)."""
    if ac is None:
        return outs
    if outs.shape[dim] < E:
        return ac.gather(outs, dim)
    return ac.sum(outs) if f_split else outs


def global_capacity(T: int, cfg: ModelConfig) -> int:
    """The global dispatch's expert capacity for ``T`` tokens."""
    m = cfg.moe
    C = int(math.ceil(T * m.top_k / m.n_experts * m.capacity_factor))
    return max(1, min(C, T))


def grouped_capacity(S: int, cfg: ModelConfig) -> int:
    """The grouped dispatch's expert capacity for a row of ``S`` tokens."""
    m = cfg.moe
    C = int(math.ceil(S * m.top_k / m.n_experts * m.capacity_factor))
    return max(1, min(C, S * m.top_k))


def moe_capacity_share(xf, r: Routing, p: Params, cfg: ModelConfig,
                       C: int, c: int = 0, n_c: int = 1, e0: int = 0):
    """One rank's share of the global dispatch's expert products: slice
    ``c`` of ``n_c`` of the capacity (rows ``[c·C/n_c, (c+1)·C/n_c)`` of
    every expert, filled from the whole batch's rows ``xf [T, D]``)
    through ``p``'s experts: all of them, the block that starts at expert
    ``e0`` (EP), or every expert's block of ``d_ff`` (expert-TP: partial
    sums).  Returns ``[E or its block, C/n_c, D]``; the slices of all
    ranks, concatenated along the capacity (and the blocks gathered or
    summed over ``model``), are the whole buffer's outputs."""
    El = (p["wd"] if cfg.act == "swiglu" else p["w2"]).shape[0]
    Cl = C // n_c
    buf, counts = _dispatch(xf, r, cfg.moe.top_k, e0, El, c * Cl, Cl)
    return _expert_products(buf, p, cfg, counts)


def moe_ffn_global(x, p: Params, cfg: ModelConfig, ac=None, rows=None):
    """Sort-based top-k MoE with static capacity (tokens over capacity are
    dropped, matching capacity-factor semantics) over all B*S tokens at
    once.  x: [B,S,D].

    On a mesh (``rows``) ``x`` is this rank's rows: their router logits
    and the rows themselves are gathered over the ranks of the rows
    (``rows.rows``), the whole batch is routed alike on every rank, and
    this rank computes its slice of the capacity where the reference's
    ``moe_buf`` rule splits it over the fsdp axes (``rows.capacity``;
    :func:`moe_capacity_share`), its experts' or its ``d_ff`` block's;
    the slices' outputs are gathered, and this rank combines its own
    tokens."""
    B, S, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    xf = x.reshape(B * S, D)
    logits = (xf @ p["router"]).float()                       # [T,E]
    group = rows.rows if rows is not None else None
    if group is not None:  # the whole batch's logits and rows
        logits, xf = group.gather(logits, 0), group.gather(xf, 0)
    T = logits.shape[0]
    C = global_capacity(T, cfg)
    r = _route(logits, K, E, C)
    cap = rows.capacity(E, C) if rows is not None else None
    c, n_c = (cap.index, cap.n) if cap is not None else (0, 1)
    e0, _, f_split = _experts_of(ac, p, cfg)
    out_buf = _expert_outputs(
        ac, moe_capacity_share(xf, r, p, cfg, C, c, n_c, e0), E, f_split, 0)
    if cap is not None:
        out_buf = cap.gather(out_buf, 1)
    own = None if group is None else (group.index * B * S, B * S)
    return _combine(out_buf, r, K, C, own).reshape(B, S, D).to(x.dtype)


def moe_grouped_share(x, r: Routing, p: Params, cfg: ModelConfig, C: int,
                      e0: int = 0):
    """One rank's share of the grouped dispatch's expert products: its
    rows ``x [B, S, D]`` through ``p``'s experts (all, the block from
    ``e0``, or every expert's block of ``d_ff``), one grouped matmul per
    batch row and weight: ``[B, E or its block, C, D]``."""
    El = (p["wd"] if cfg.act == "swiglu" else p["w2"]).shape[0]
    buf, counts = _dispatch(x, r, cfg.moe.top_k, e0, El, 0, C)
    return torch.stack([_expert_products(buf[b], p, cfg, counts[b])
                        for b in range(x.shape[0])])


def moe_ffn_grouped(x, p: Params, cfg: ModelConfig, ac=None):
    """Group-local MoE dispatch: routing, sort, capacity, scatter and
    combine within each batch row (capacity enforced per row).  The
    expert products run one grouped matmul per batch row and weight.  On
    a mesh each rank dispatches, computes and combines its own rows: no
    row leaves its rank."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    C = grouped_capacity(x.shape[1], cfg)
    r = _route((x @ p["router"]).float(), K, E, C)            # [B,S,E]
    e0, _, f_split = _experts_of(ac, p, cfg)
    out_buf = _expert_outputs(ac, moe_grouped_share(x, r, p, cfg, C, e0),
                              E, f_split, 1)
    return _combine(out_buf, r, K, C).to(x.dtype)


def moe_aux_loss(x, p: Params, cfg: ModelConfig, rows=None):
    """Load-balancing auxiliary loss (Switch-style) of x [B,S,D]: the
    experts' share of the routed entries (the :func:`topk` experts, as the
    dispatch picks them) against their mean router probability, times
    ``n_experts``; a scalar f32.  The shares count entries, so they carry
    no gradient (as in the reference).  On a mesh (``rows``: the
    executor's :class:`~repro_torch.parallel.split.MoERows`) the
    statistics are the whole batch's, as on one device: the global
    dispatch takes them from the gathered router logits, the grouped one
    adds its counts and probability sums over the ranks of the rows."""
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    logits = (x.reshape(T, -1) @ p["router"]).float()
    group = rows.rows if rows is not None else None
    if group is not None and cfg.moe_impl != "grouped":
        logits, group = group.gather(logits, 0), None
        T = logits.shape[0]
    probs = torch.softmax(logits, dim=-1)
    _, idx = topk(logits, m.top_k)
    # the reference's .at[idx].add(1.0): whole numbers, exact in any order
    flat = idx.reshape(-1)
    counts = torch.zeros(m.n_experts, dtype=torch.float32,
                         device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=x.device))
    if group is None:
        frac_tokens = counts / (T * m.top_k)
        frac_probs = probs.mean(dim=0)
    else:
        counts, prob_sums = group.sum(counts), group.sum(probs.sum(dim=0))
        T *= group.n
        frac_tokens = counts / (T * m.top_k)
        frac_probs = prob_sums / T
    return m.n_experts * torch.sum(frac_tokens * frac_probs)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / recurrentgemma)
# ---------------------------------------------------------------------------


def init_rglru(cfg: ModelConfig, dtype, device, generator
               ) -> Dict[str, torch.Tensor]:
    d, dr, cw = cfg.d_model, cfg.d_rnn or cfg.d_model, cfg.conv_width
    s, sr = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dr)
    p = {name: normal(shape, scale, dtype, device, generator)
         for name, shape, scale in (("w_in_rec", (d, dr), s),
                                    ("w_in_gate", (d, dr), s),
                                    ("w_out", (dr, d), sr),
                                    ("conv_w", (cw, dr), 0.1),
                                    ("w_r", (dr, dr), sr),
                                    ("w_i", (dr, dr), sr))}
    # sigmoid(4) ≈ 0.98: a slow decay
    p["lam"] = torch.full((dr,), 4.0, dtype=dtype, device=device)
    return p


_RG_C = 8.0


def _log_sigmoid(x):
    return -F.softplus(-x)            # the JAX layers' -softplus(-x)


def _rglru_gates(u, p: Params, ac=None):
    """The decay ``a`` and input scale ``b`` of each step, f32 [B,S,dr]
    (this rank's channels where they are split: the gates' products read
    every channel of ``u``, gathered)."""
    uw = ac.gather(u, 2) if ac is not None and \
        u.shape[-1] < p["w_r"].shape[0] else u
    r = torch.sigmoid(f32up(uw @ p["w_r"]))
    i = torch.sigmoid(f32up(uw @ p["w_i"]))
    log_a = _RG_C * r * _log_sigmoid(f32up(p["lam"]))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * i


def _causal_conv(u, w, state=None):
    """Depthwise causal conv along time.  u: [B,S,dr], w: [cw,dr]; state:
    the carried tail [B,cw-1,dr] of the steps before (zeros when None).
    Returns (out [B,S,dr], the new tail: the last cw-1 steps of
    ``state`` followed by ``u``)."""
    B, S, dr = u.shape
    cw = w.shape[0]
    pad = torch.zeros((B, cw - 1, dr), dtype=u.dtype, device=u.device) \
        if state is None else state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    out = sum(full[:, i:i + S] * w[i] for i in range(cw))
    return out, full[:, full.shape[1] - (cw - 1):]


def rglru(x, p: Params, cfg: ModelConfig, state=None, ac=None):
    """x: [B,S,D] -> (y [B,S,D], new state).  state: {"h": [B,dr] f32,
    "conv": [B,cw-1,dr]}, zeros when None.  One function for the prefill
    and the decode (S = 1): both run the recurrence on the RG-LRU scan
    kernel, from ``h0`` zeros or the state's ``h``.  On a split mesh the
    gates, the conv and the scan run on this rank's channels
    ``[B, S, dr/n]`` (and the state holds them), ``w_out``
    row-parallel."""
    x = _mm_input(ac, x)
    B, S, D = x.shape
    u = x @ p["w_in_rec"]
    gate = _gelu(x @ p["w_in_gate"])
    u, new_conv = _causal_conv(u, p["conv_w"],
                               None if state is None else state["conv"])
    a, b = _rglru_gates(u, p, ac)                # [B,S,dr] f32
    bu = b * f32up(u)
    h0 = torch.zeros((B, u.shape[-1]), dtype=wide(x.dtype),
                     device=x.device) if state is None \
        else f32up(state["h"])
    hs, h_final = rglru_scan(a, bu, h0)
    y = _row_parallel(ac, hs.to(x.dtype) * gate, p["w_out"],
                      cfg.d_rnn or cfg.d_model)
    return y, {"h": h_final, "conv": new_conv}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory)
# ---------------------------------------------------------------------------


def init_mlstm(cfg: ModelConfig, dtype, device, generator
               ) -> Dict[str, torch.Tensor]:
    d, H = cfg.d_model, cfg.n_heads
    de = 2 * d
    s = 1.0 / math.sqrt(d)
    return {name: normal(shape, scale, dtype, device, generator)
            for name, shape, scale in (("w_qkv", (d, 3 * de), s),
                                       ("w_o", (de, d), 1 / math.sqrt(de)),
                                       ("w_if", (d, 2 * H), s),
                                       ("w_skip", (d, de), s))}


def _head_split(kind: str, cfg: ModelConfig, n: int):
    """How a split of ``n`` ranks over ``model`` divides an mLSTM's or
    sLSTM's heads: ``(heads a rank, blocks a head)``, ``(H / n, 1)`` where
    ``n`` divides the ``H`` heads, ``(1, n / H)`` where ``H`` divides
    ``n`` and the blocks divide a head's split columns (the mLSTM's value
    columns, the sLSTM's rows of ``w_o``); None where neither holds, and
    the mixer computes whole on every rank."""
    H = cfg.n_heads
    width = (2 if kind == MLSTM else 1) * cfg.d_model // H
    if H % n == 0:
        return H // n, 1
    if n % H == 0 and width % (n // H) == 0:
        return 1, n // H
    return None


def _heads_of(kind: str, cfg: ModelConfig, index: int, n: int):
    """(first head, heads, block, blocks a head) of rank ``index`` of
    ``n``; ``(0, H, 0, 1)`` for ``n = 1``."""
    hl, g = _head_split(kind, cfg, n)
    return index // g * hl, hl, index % g, g


def whole_params(kind: str, cfg: ModelConfig, n: int) -> frozenset:
    """The parameters of an mLSTM or sLSTM mixer (``kind``) that a split
    of ``n`` ranks over ``model`` gathers whole: the fused columns that
    each rank regroups by its heads (the mLSTM's ``w_qkv``, the sLSTM's
    gate-major ``w_x``), or every one where the split cannot divide the
    heads (:func:`_head_split`)."""
    if _head_split(kind, cfg, n) is None:
        return frozenset(("w_qkv", "w_if", "w_skip", "w_o") if kind == MLSTM
                         else ("w_x", "r", "w_o"))
    return frozenset(("w_qkv",) if kind == MLSTM else ("w_x",))


def state_layouts(kind: str, cfg: ModelConfig, n: int) -> Dict:
    """How a split of ``n`` ranks holds an mLSTM's or sLSTM's state
    tensors (:meth:`~repro_torch.parallel.split.ModelSplit.relayout`'s
    layouts): by heads (dim 1), or, where each head runs on ``n / H``
    ranks, the mLSTM's ``C [B, H, hk, hv]`` by heads and value columns and
    its ``n``, ``m`` and the sLSTM's states by heads alone, each on the
    ranks of its head; None: whole."""
    keys = ("C", "n", "m") if kind == MLSTM else ("c", "n", "h", "m")
    split = _head_split(kind, cfg, n)
    if split is None:
        return dict.fromkeys(keys)
    hl, g = split
    if g == 1:
        return dict.fromkeys(keys, 1)
    H = cfg.n_heads
    out = dict.fromkeys(keys, ((1, H),))
    if kind == MLSTM:
        out["C"] = ((1, H), (3, g))
    return out


def _split_mixer(share, kind: str, x, p: Params, cfg: ModelConfig, state,
                 ac):
    """An mLSTM or sLSTM (``kind``) over ``x``, from its share function
    ``share(x, p, cfg, state, index, n) -> (partial output, state)``: on
    one device the whole (``n = 1``); on a split mesh (``ac``) this rank's
    heads, or its block of one head, on the gathered sequence, the partial
    outputs of its rows of ``w_o`` added over ``model`` (the reference
    splits ``w_o`` by rows); where the split cannot divide the heads,
    whole on every rank."""
    if ac is None:
        return share(x, p, cfg, state)
    x = ac(x, "mm_input")
    if _head_split(kind, cfg, ac.n) is None:
        y, state = share(x, p, cfg, state)
        return (ac.own(y, 1) if ac.seq else y), state
    y, state = share(x, p, cfg, state, ac.index, ac.n)
    return ac.sum_seq(y), state


def _mlstm_inputs(x, p: Params, cfg: ModelConfig, index: int = 0,
                  n: int = 1):
    """q, k (scaled by 1/√hd), v ``[B,S,h,·]`` and the log input and
    forget gates ``[B,S,h]`` f32 of rank ``index`` of ``n``'s heads: all
    ``H`` for ``n = 1``; ``H / n`` heads, or one head's block of ``hd / g``
    value columns where its ``g = n / H`` ranks share it (the reference's
    ``ffn_hidden`` constraint on the fused projection, regrouped by
    heads: ``p["w_qkv"]`` is whole, and the rank takes its heads' q, k and
    v columns; ``w_if`` its heads' gate columns)."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = 2 * D // H
    w, w_if = p["w_qkv"], p["w_if"]
    if n == 1:
        q, k, v = (x @ w).split(2 * D, dim=-1)
        hl = H
    else:
        h0, hl, b, g = _heads_of(MLSTM, cfg, index, n)
        vb, de = hd // g, 2 * D
        qk = slice(h0 * hd, (h0 + hl) * hd)
        v0 = 2 * de + h0 * hd + b * vb
        w = torch.cat([w[:, qk], w[:, de + qk.start:de + qk.stop],
                       w[:, v0:v0 + hl * vb]], dim=1)
        w_if = torch.cat([w_if[:, h0:h0 + hl], w_if[:, H + h0:H + h0 + hl]],
                         dim=1)
        q, k, v = (x @ w).split([hl * hd, hl * hd, hl * vb], dim=-1)
    q = q.reshape(B, S, hl, hd) / math.sqrt(hd)
    k = k.reshape(B, S, hl, hd) / math.sqrt(hd)
    v = v.reshape(B, S, hl, -1)
    gates = f32up(x @ w_if).reshape(B, S, 2, hl)
    return q, k, v, _log_sigmoid(gates[:, :, 0]), _log_sigmoid(gates[:, :, 1])


def _mlstm_out(x, h, p: Params):
    """The block's output from the cell's h ``[B,S,2D]`` (on a split mesh
    this rank's columns of it, with its columns of ``w_skip`` and rows of
    ``w_o``: the partial output)."""
    return (h.to(x.dtype) * F.silu(x @ p["w_skip"])) @ p["w_o"]


def mlstm(x, p: Params, cfg: ModelConfig, state=None, ac=None):
    """Stabilized mLSTM.  state: {"C": [B,H,hd,hd], "n": [B,H,hd], "m":
    [B,H]}, f32.  The chunked form for full sequences when
    ``cfg.mlstm_impl == "chunked"``; the decode (S = 1) stays per-step.
    On a split mesh (``ac``) the state holds this rank's heads or value
    columns (:func:`state_layouts`)."""
    if cfg.mlstm_impl == "chunked" and x.shape[1] > 1:
        return mlstm_chunked(x, p, cfg, state, chunk=cfg.mlstm_chunk, ac=ac)
    return _mlstm_scan(x, p, cfg, state, ac=ac)


def _mlstm_state(state, B: int, H: int, hk: int, hv: int, device):
    if state is None:
        f32 = dict(dtype=torch.float32, device=device)
        return (torch.zeros((B, H, hk, hv), **f32),
                torch.zeros((B, H, hk), **f32),
                torch.full((B, H), -1e30, **f32))
    return tuple(state[k].float() for k in ("C", "n", "m"))


def _mlstm_scan(x, p: Params, cfg: ModelConfig, state=None, ac=None):
    """The per-step recurrence in plain tensor ops, the JAX ``lax.scan``
    step for step (on a split mesh: :func:`_split_mixer`)."""
    return _split_mixer(mlstm_scan_share, MLSTM, x, p, cfg, state, ac)


def mlstm_scan_share(x, p: Params, cfg: ModelConfig, state=None,
                     index: int = 0, n: int = 1):
    """Rank ``index`` of ``n``'s share of :func:`_mlstm_scan`: the
    recurrence of its heads or value columns (:func:`_mlstm_inputs`), its
    partial output and its state.  The normalizer and the stabilizer are
    per head: every rank of a head computes them alike."""
    B, S, _ = x.shape
    q, k, v, log_i, log_f = _mlstm_inputs(x, p, cfg, index, n)
    hl, hk, hv = q.shape[2], q.shape[3], v.shape[3]
    C, nrm, m = _mlstm_state(state, B, hl, hk, hv, x.device)
    hs = []
    for t in range(S):
        q_t, k_t, v_t = q[:, t].float(), k[:, t].float(), v[:, t].float()
        li, lf = log_i[:, t], log_f[:, t]                # [B,H]
        m_new = torch.maximum(lf + m, li)
        f_sc = torch.exp(lf + m - m_new)[..., None]
        i_sc = torch.exp(li - m_new)[..., None]
        C = f_sc[..., None] * C + i_sc[..., None] * (
            k_t[..., :, None] * v_t[..., None, :])
        nrm = f_sc * nrm + i_sc * k_t
        num = torch.einsum("bhk,bhkv->bhv", q_t, C)
        den = torch.einsum("bhk,bhk->bh", q_t, nrm).abs()
        hs.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, hl * hv)
    return _mlstm_out(x, h, p), {"C": C, "n": nrm, "m": m}


def _ones_width(hd: int) -> int:
    """Columns of ``v`` with the normalizer's column of ones: ``hd + 1``
    rounded up to a multiple of 4, so that the kernels load its rows in
    16-byte copies (the columns past the ones are zeros, cut off)."""
    return (hd + 1 + 3) // 4 * 4


def mlstm_chunked(x, p: Params, cfg: ModelConfig, state=None,
                  chunk: int = 128, ac=None):
    """Chunked mLSTM on the ``mlstm_chunk`` kernel: the same function as
    :func:`_mlstm_scan` with the matrix state crossing memory once per
    chunk of ``min(chunk, S)`` steps (``S`` a multiple of it, as in the
    JAX package).

    The kernel is the *unstabilized* core ``C_t = f_t C_{t-1} + i_t k_t
    v_tᵀ``, ``y_t = q_t C_t``, fed ``lf = log σ(f)`` and ``gi = σ(i)``.
    The normalizer ``n_t = f_t n_{t-1} + i_t k_t`` rides along as a column
    of ones appended to ``v``: ``y[..., hv]`` is ``q_t·n_t`` and the final
    state's column ``hv`` is ``n_T``.  Then ``h_t = q_t·C_t / max(|q_t·n_t|,
    1)``, which is the JAX package's ``num / max(den, e^{-m_t})`` exactly:
    its stabilized state is ``Ĉ = C e^{-m}``.  Every log-gate is ≤ 0
    (sigmoid gates), so the kernel's exponents are ≤ 0, nothing overflows,
    and ``e^{m} ≤ 1``.

    The returned state is ``C = C_T``, ``n = n_T``, ``m = 0``: the JAX
    package's ``(Ĉ, n̂, m)`` in another scaling.  The per-step decode
    (:func:`_mlstm_scan`) is invariant under that scaling, so it continues
    from either; compare ``C·e^{m}`` and ``n·e^{m}``, never the raw entries.
    A given ``state`` enters by linearity: its unscaled ``[C·e^{m} | n·e^{m}]``
    decayed by ``e^{L_t}`` (``L`` the cumulative log-forget) is added to
    the kernel's outputs and final state.

    On a split mesh (``ac``; :func:`_split_mixer`) the kernel runs on this
    rank's heads, or on its block of a head's value columns with the
    column of ones of its own: the value columns are independent, so the
    blocks of a head together are the head."""
    return _split_mixer(functools.partial(mlstm_chunked_share, chunk=chunk),
                        MLSTM, x, p, cfg, state, ac)


def mlstm_chunked_share(x, p: Params, cfg: ModelConfig, state=None,
                        index: int = 0, n: int = 1, chunk: int = 128):
    """Rank ``index`` of ``n``'s share of :func:`mlstm_chunked`: its heads
    or value columns on the ``mlstm_chunk`` kernel, its partial output and
    its state."""
    B, S, D = x.shape
    bt = min(chunk, S)
    if S % bt:
        raise ValueError(f"seq_len {S} must divide the mLSTM chunk {bt}")
    q, k, v, log_i, log_f = _mlstm_inputs(x, p, cfg, index, n)
    hl, hk, hv = q.shape[2], q.shape[3], v.shape[3]

    def heads(t):               # [B,S,h,...] -> [B*h,S,...] f32
        t = f32up(t).transpose(1, 2)
        return t.reshape(B * hl, S, *t.shape[3:])

    q, k, v = heads(q), heads(k), heads(v)
    lf = heads(log_f)[..., None]                      # [B*h,S,1]
    gi = torch.exp(heads(log_i))[..., None]
    dv = _ones_width(hv)
    f32 = dict(dtype=wide(x.dtype), device=x.device)
    v1 = torch.cat([v, torch.ones((B * hl, S, 1), **f32),
                    torch.zeros((B * hl, S, dv - hv - 1), **f32)], dim=-1)
    y, c_fin = mlstm_chunk(q, k, v1, lf, gi, bt)
    if state is not None:
        C0, n0, m0 = _mlstm_state(state, B, hl, hk, hv, x.device)
        w = torch.exp(m0).reshape(B * hl, 1, 1)
        s0 = torch.zeros((B * hl, hk, dv), **f32)
        s0[..., :hv] = C0.reshape(B * hl, hk, hv) * w
        s0[..., hv] = n0.reshape(B * hl, hk) * w[..., 0]
        decay = torch.exp(torch.cumsum(lf, dim=1))    # [B*h,S,1]
        y = y + decay * (q @ s0)
        c_fin = c_fin + decay[:, -1:] * s0
    h = y[..., :hv] / torch.clamp(y[..., hv:hv + 1].abs(), min=1.0)
    h = h.reshape(B, hl, S, hv).transpose(1, 2).reshape(B, S, hl * hv)
    return _mlstm_out(x, h, p), {
        "C": c_fin[..., :hv].reshape(B, hl, hk, hv),
        "n": c_fin[..., hv].reshape(B, hl, hk),
        "m": torch.zeros((B, hl), **f32)}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory)
# ---------------------------------------------------------------------------


def init_slstm(cfg: ModelConfig, dtype, device, generator
               ) -> Dict[str, torch.Tensor]:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    s = 1.0 / math.sqrt(d)
    return {"w_x": normal((d, 4 * d), s, dtype, device, generator),
            # block-diagonal recurrent weights, per head
            "r": normal((H, dh, 4 * dh), 1 / math.sqrt(dh), dtype, device,
                        generator),
            "w_o": normal((d, d), s, dtype, device, generator)}


def slstm(x, p: Params, cfg: ModelConfig, state=None, ac=None):
    """sLSTM with exponential gating, a per-step loop in plain tensor ops
    (no TPU kernel computes it).  state: {"c","n","h","m": [B,D]} f32;
    ``n`` starts at ones.  On a split mesh (``ac``; :func:`_split_mixer`)
    each rank runs the loop for its heads: the recurrence is
    block-diagonal per head, so a head cannot split without a collective
    every step, and where ``n`` exceeds the heads each head runs on ``n /
    H`` ranks, each of which multiplies its block of the head's ``h`` by
    its rows of ``w_o``."""
    return _split_mixer(slstm_share, SLSTM, x, p, cfg, state, ac)


def slstm_share(x, p: Params, cfg: ModelConfig, state=None, index: int = 0,
                n: int = 1):
    """Rank ``index`` of ``n``'s share of :func:`slstm`: the loop over its
    heads (``w_x``'s four gate blocks of their columns; ``p["w_x"]`` whole,
    ``p["r"]`` whole or its heads), its partial output and its state."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    w_x, r = p["w_x"], p["r"]
    h0, hl, b, g = (0, H, 0, 1) if n == 1 else \
        _heads_of(SLSTM, cfg, index, n)
    if n > 1:
        w_x = torch.cat([w_x[:, j * D + h0 * dh:j * D + (h0 + hl) * dh]
                         for j in range(4)], dim=1)
        if r.shape[0] == H:
            r = r[h0:h0 + hl]
    Dl = hl * dh
    zx = x @ w_x                                       # [B,S,4*Dl]
    if state is None:
        f32 = dict(dtype=wide(x.dtype), device=x.device)
        c, nrm, h, m = (torch.zeros((B, Dl), **f32),
                        torch.ones((B, Dl), **f32),
                        torch.zeros((B, Dl), **f32),
                        torch.zeros((B, Dl), **f32))
    else:
        c, nrm, h, m = (f32up(state[k]) for k in ("c", "n", "h", "m"))
    # recurrent weights laid out gate-major to match w_x's [4*D] layout
    r = f32up(r).reshape(hl, dh, 4, dh)
    hs = []
    # the steps of zx taken apart once (one op in the backward, where a
    # slice a step would fill a zero gradient of the whole of zx each step)
    for zx_t in f32up(zx).unbind(1):
        zr = torch.einsum("bhk,hkgj->bghj", h.reshape(B, hl, dh), r)
        z = zx_t + zr.reshape(B, 4 * Dl)
        zi, zf, zz, zo = z.chunk(4, dim=-1)
        m_new = torch.maximum(zf + m, zi)
        i = torch.exp(zi - m_new)
        f = torch.exp(zf + m - m_new)
        c = f * c + i * torch.tanh(zz)
        nrm = f * nrm + i
        h = torch.sigmoid(zo) * c / torch.clamp(nrm, min=1e-6)
        m = m_new
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    if g > 1:  # this rank's rows of w_o: its block of the head's columns
        hs = hs[..., b * dh // g:(b + 1) * dh // g]
    y = hs.to(x.dtype) @ p["w_o"]
    return y, {"c": c, "n": nrm, "h": h, "m": m}
