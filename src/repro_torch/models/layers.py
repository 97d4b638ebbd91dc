"""Model primitives of the serving path: norms, RoPE, GQA attention
(full/windowed prefill and one-token decode), SwiGLU/GELU FFN and the
sort-based MoE.  Port of ``src/repro/models/layers.py`` for the block kinds
``ATTN``/``SWA`` + ``DENSE_FFN``/``MOE_FFN``.

Every function is a plain function over tensors and a parameter mapping
``p`` (name -> tensor, in the JAX package's layouts: ``x @ p["wq"]``); the
``nn.Module`` owners live in :mod:`repro_torch.models.model`.  Two
products go through the port's hand-written kernels, by their public ops:

* the prefill's self-attention core: :func:`repro_torch.kernels.
  flash_attention` on ``[B, H, S, d]`` with kv repeated to ``H`` heads
  (on the card the wgmma/TMA kernel for bf16, the CUDA-core kernel for
  f32; on CPU tensors the plain version);
* every expert product of the MoE: :func:`repro_torch.kernels.moe_gmm` on
  the capacity buffer ``[E, C, D] @ [E, D, F]`` with ``counts[e]`` the rows
  kept for expert ``e``.

The decode's attention against the cache stays plain torch ops: the JAX
package computes it outside any Pallas kernel, and the flash kernel
assumes aligned q and k positions.

Not in this slice: RG-LRU, mLSTM, sLSTM and cross-attention (the model
refuses those blocks, :mod:`repro_torch.models.model`).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import flash_attention, moe_gmm

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


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
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


def attention(x, p: Params, cfg: ModelConfig, *,
              window: Optional[int] = None, positions=None):
    """Causal (windowed when ``window``) self-attention over x [B,S,D];
    the core runs on the flash attention kernel.  Returns ``(y, k, v)``
    with the rotated keys and the values ``[B,S,Hkv,hd]`` that the cache
    keeps (the JAX prefill projects them a second time)."""
    B, S, D = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (x @ p["wk"]).reshape(B, S, hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, hkv, hd)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(q.transpose(1, 2), repeat_kv(k, h).transpose(1, 2),
                        repeat_kv(v, h).transpose(1, 2), True,
                        window)                             # [B,H,S,hd]
    return o.transpose(1, 2).reshape(B, S, h * hd) @ p["wo"], k, v


def attention_decode(x, p: Params, cfg: ModelConfig, cache, pos: int, *,
                     window: Optional[int] = None):
    """One-token decode against a cache.

    cache: {"k","v": [B, S_cache, Hkv, hd]} — a ring buffer when windowed
    (slot ``pos % S_cache``).  pos: absolute position of the new token.
    The new k/v are written into ``cache`` in place (the JAX package
    returns an updated copy); returns (y [B,1,D], cache)."""
    B, S, D = x.shape  # S == 1
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, 1, h, hd)
    k_new = (x @ p["wk"]).reshape(B, 1, hkv, hd)
    v_new = (x @ p["wv"]).reshape(B, 1, hkv, hd)
    posv = torch.full((B, 1), pos, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k_new = rope(k_new, posv, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    S_cache = k.shape[1]
    if window is None and pos >= S_cache:
        raise ValueError(f"position {pos} is past the cache of {S_cache}")
    slot = pos % S_cache if window is not None else pos
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)

    idx = torch.arange(S_cache, device=x.device)
    if window is not None:
        # ring buffer: slot i holds position pos - ((pos - i) mod S_cache)
        kpos = pos - ((pos - idx) % S_cache)
        valid = (kpos >= 0) & (kpos >= pos - window + 1) & (kpos <= pos)
    else:
        valid = idx <= pos

    scale = 1.0 / math.sqrt(hd)
    G = h // hkv
    qh = q.reshape(B, 1, hkv, G, hd)
    s = torch.einsum("bckgh,bskh->bkgcs", qh.float(), k.float()) * scale
    s = torch.where(valid, s, -torch.inf)
    m = torch.clamp(s.amax(-1, keepdim=True), min=-1e30)
    pbar = torch.exp(s - m)
    l = pbar.sum(-1, keepdim=True)
    o = torch.einsum("bkgcs,bskh->bckgh", pbar / torch.clamp(l, min=1e-30),
                     v.float())
    o = o.reshape(B, 1, h * hd).to(x.dtype)
    return o @ p["wo"], cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def ffn(x, p: Params, cfg: ModelConfig):
    if cfg.act == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return _gelu(x @ p["w1"]) @ p["w2"]


# ---------------------------------------------------------------------------
# MoE (sort-based capacity dispatch)
# ---------------------------------------------------------------------------


def moe_ffn(x, p: Params, cfg: ModelConfig):
    if cfg.moe_impl == "grouped":
        return moe_ffn_grouped(x, p, cfg)
    return moe_ffn_global(x, p, cfg)


def _route(logits, K: int, E: int, C: int):
    """Top-k routing with a stable sort by expert, as the JAX dispatch
    computes it, over the last two dimensions of ``logits [..., T, E]``
    (``N = T * K`` entries): the softmaxed gates ``[..., T, K]``, the
    sort ``order [..., N]``, each sorted entry's expert ``sorted_e``, its
    rank within its expert and ``counts [..., E]``, the rows kept for each
    expert (``min(routed, C)``).  Nothing here waits for the device.
    Router logits that tie may be ranked otherwise than by ``lax.top_k``
    (lower index first); continuous inputs tie with probability 0."""
    gates, idx = torch.topk(logits, K, dim=-1)
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
    return gates, order, sorted_e, rank, (ends - starts).clamp(max=C)


def _expert_products(buf, p: Params, cfg: ModelConfig, counts):
    """The experts' FFN on their capacity buffer ``[E, C, D]``: each
    product on the grouped matmul kernel, rows past ``counts[e]`` dead."""
    if cfg.act == "swiglu":
        h = F.silu(moe_gmm(buf, p["wg"], counts)) \
            * moe_gmm(buf, p["wu"], counts)
        return moe_gmm(h, p["wd"], counts)
    return moe_gmm(_gelu(moe_gmm(buf, p["w1"], counts)), p["w2"], counts)


def moe_ffn_global(x, p: Params, cfg: ModelConfig):
    """Sort-based top-k MoE with static capacity (tokens over capacity are
    dropped, matching capacity-factor semantics) over all B*S tokens at
    once.  x: [B,S,D]."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = int(math.ceil(T * K / E * m.capacity_factor))
    C = max(1, min(C, T))

    xf = x.reshape(T, D)
    logits = (xf @ p["router"]).float()                      # [T,E]
    gates, order, sorted_e, rank, counts = _route(logits, K, E, C)
    tok = order // K                                          # token of entry
    keep = rank < C
    slot_e = torch.where(keep, sorted_e, E)                   # drop -> row E
    slot_c = torch.where(keep, rank, 0)

    # dropped entries land in a spare expert row that is cut off
    buf = torch.zeros((E + 1, C, D), dtype=x.dtype, device=x.device)
    buf[slot_e, slot_c] = xf[tok]
    out_buf = _expert_products(buf[:E], p, cfg, counts)

    gathered = out_buf[sorted_e, slot_c]                      # [T*K, D]
    w = gates.reshape(-1)[order] * keep.to(gates.dtype)
    contrib = gathered * w[:, None].to(gathered.dtype)
    out = torch.zeros((T, D), dtype=contrib.dtype, device=x.device)
    out.index_add_(0, tok, contrib)
    return out.reshape(B, S, D).to(x.dtype)


def moe_ffn_grouped(x, p: Params, cfg: ModelConfig):
    """Group-local MoE dispatch: routing, sort, capacity, scatter and
    combine within each batch row (capacity enforced per row).  The
    expert products run one grouped matmul per batch row and weight."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    C = int(math.ceil(S * K / E * m.capacity_factor))
    C = max(1, min(C, S * K))
    SK = S * K

    logits = (x @ p["router"]).float()                       # [B,S,E]
    gates, order, sorted_e, rank, counts = _route(logits, K, E, C)
    tok = order // K                                          # [B,SK]
    keep = rank < C
    slot_e = torch.where(keep, sorted_e, E)                   # drop -> row E
    slot_c = torch.where(keep, rank, 0)

    brow = torch.arange(B, device=x.device)[:, None].expand(B, SK)
    xg = torch.gather(x, 1, tok[..., None].expand(B, SK, D))  # [B,SK,D]
    buf = torch.zeros((B, E + 1, C, D), dtype=x.dtype, device=x.device)
    buf[brow, slot_e, slot_c] = xg
    out_buf = torch.stack([_expert_products(buf[b, :E], p, cfg, counts[b])
                           for b in range(B)])

    gathered = out_buf[brow, sorted_e, slot_c]                # [B,SK,D]
    w = torch.gather(gates.reshape(B, SK), 1, order) * keep.to(gates.dtype)
    contrib = gathered * w[..., None].to(gathered.dtype)
    out = torch.zeros((B * S, D), dtype=contrib.dtype, device=x.device)
    out.index_add_(0, (brow * S + tok).reshape(-1), contrib.reshape(-1, D))
    return out.reshape(B, S, D).to(x.dtype)
