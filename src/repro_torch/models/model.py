"""Model assembly: embeddings, blocks, caches, the training forward,
prefill and decode.  Port of ``src/repro/models/model.py`` for every family:
attention (block kinds ``ATTN``/``SWA``), the recurrent mixers (``RGLRU``,
``MLSTM``, ``SLSTM``), each with ``DENSE_FFN``, ``MOE_FFN`` or ``NO_FFN``,
the ``patch`` frontend stub, and the encoder–decoder family (whisper): a
bidirectional :class:`Encoder` over the ``audio`` frontend's frame
embeddings, and decoder blocks with cross-attention on its output.

:class:`Model` is an ``nn.Module`` holding the embedding table (padded
vocab rows), one :class:`Block` per layer in a plain ``ModuleList`` (the
JAX package stacks each layer group for ``lax.scan``), the final norm, the
untied unembedding where the config has one, and the frontend projection.
Parameters keep the JAX layouts and names, so ``state_dict()`` keys read
like the JAX tree's paths (``blocks.3.mixer.wq`` for layer 3's
``groups[g]["slot0"]["mixer"]["wq"][r]``; see :mod:`.convert`).
Parameters require gradients: :meth:`Model.forward_train` returns the loss
with its graph, each block recomputed in the backward pass when ``remat``
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of each
group body); :meth:`Model.encode`, :meth:`Model.prefill` and
:meth:`Model.decode_step` serve, and run without autograd.

A model lives on one device: ``cuda:0`` unless the caller names another
(``device="cpu"`` runs the kernels' plain versions; ``"meta"`` allocates
nothing, for parameter counts and the dry run).  On a mesh of several
ranks its parameters are ``DTensor`` shards and :attr:`Model.executor`
(set by :meth:`repro_torch.parallel.executor.MeshExecutor.bind`) makes
each module's parameters whole (or this rank's block of their ``model``
split) right before the module computes and drops them after, and hands
each MoE layer its view of the batch's rows
(:meth:`~repro_torch.parallel.executor.MeshExecutor.moe_rows`); where
``model`` has several ranks, the executor's
:class:`~repro_torch.parallel.split.ModelSplit` is the ``ac`` hook the
blocks hand to the layers (the reference's ``ac`` points: heads, FFN
hidden, experts, RG-LRU channels, mLSTM and sLSTM heads, the vocab of the
embedding and the logits with a vocab-parallel cross-entropy, and under
``seq_shard`` a residual split over the sequence).  With no executor (one device) every
hook below is a plain call and ``ac`` is None.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import (ATTN, DENSE_FFN, MLSTM, MOE_FFN, NO_FFN, RGLRU,
                            SLSTM, SWA, BlockSpec, ModelConfig)
from ..core.backends.base import resolve_device
from . import layers as L

Cache = Dict[str, torch.Tensor]

def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class ParamDict(nn.Module):
    """A named set of parameters (one entry of the JAX tree's dicts);
    :attr:`p` is the mapping the layer functions take."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    @property
    def p(self) -> Dict[str, torch.Tensor]:
        return self._parameters


def _gathered(executor, module, names=None):
    """A context in which ``module``'s parameters (only its own ones named
    in ``names``, where given) are whole tensors for the compute: they are
    on one device (no executor); a mesh executor gathers them."""
    if executor is None:
        return contextlib.nullcontext()
    return executor.gathered(module, names)


def _call(executor, module, fn, *args):
    """``fn(*args)`` with ``module``'s parameters whole (:func:`_gathered`);
    under remat the recompute calls it again, and gathers again."""
    with _gathered(executor, module):
        return fn(*args)


def _split_at(executor, seq_len: int):
    """The executor's :class:`~repro_torch.parallel.split.ModelSplit` for
    a residual of ``seq_len`` positions, or None (one device, or whole
    layers)."""
    ac = executor.model_split() if executor is not None else None
    return None if ac is None else ac.at(seq_len)


def _whole_columns(ac, y, n: int):
    """A product's output whole: its ``n`` columns gathered where the
    weight's columns are split over ``model``."""
    return ac.gather(y, -1) if ac is not None and y.shape[-1] < n else y


def head_logits(x, w, ac, vocab: int, shard: bool = True):
    """The f32 logits ``x @ w`` of the head ``w [D, V or V/n]``.  Where
    ``w``'s vocab columns are split over ``model`` they are this rank's
    slice, or with ``shard`` false (``ParallelCfg.shard_logits``, the
    reference's whole-logits constraint) every rank's slices gathered
    whole over ``model``."""
    logits = L.f32up(x @ w.to(x.dtype))
    if ac is not None and not shard and logits.shape[-1] < vocab:
        return ac.gather(logits, -1)
    return logits


def token_nll(logits, labels, ac, vocab: int):
    """Each position's negative log-likelihood of its label, f32.  On a
    vocab split over ``model``: the max and the sum of exponentials
    combined over ``model`` (a log-sum-exp), the label's logit taken by
    the rank that holds it."""
    V_local = logits.shape[-1]
    if ac is None or V_local == vocab:
        # the label's logit by a gather: the reference's one-hot sum adds
        # exact zeros to it
        return torch.logsumexp(logits, dim=-1) \
            - logits.gather(-1, labels[..., None])[..., 0]
    m = ac.max(logits.amax(-1, keepdim=True))
    lse = torch.log(ac.sum(torch.exp(logits - m).sum(-1))) + m[..., 0]
    local = labels - ac.index * V_local
    inside = (local >= 0) & (local < V_local)
    own = logits.gather(-1, local.clamp(0, V_local - 1)[..., None])
    return lse - ac.sum(own[..., 0] * inside.to(own.dtype))


#: the recurrent mixers, by block kind: the keys of their state (cache)
STATE_KEYS = {RGLRU: ("h", "conv"), MLSTM: ("C", "n", "m"),
              SLSTM: ("c", "n", "h", "m")}


class Block(nn.Module):
    """One block: pre-norm mixer (attention or a recurrent cell), pre-norm
    cross-attention on an encoder's output where ``spec.cross_attn``, and
    pre-norm FFN (dense, MoE or none), each added to the residual stream.
    An attention block's cache is its k/v (and the encoder's cross k/v); a
    recurrent block's is its state, which the prefill returns and the
    decode updates in place."""

    #: the mesh executor, which hands the MoE its view of the batch's rows
    executor = None

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, dtype, device,
                 generator):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.window = cfg.window if spec.mixer == SWA else None
        self.norm1 = ParamDict(L.init_norm(cfg, dtype, device))
        init = {ATTN: L.init_attention, SWA: L.init_attention,
                RGLRU: L.init_rglru, MLSTM: L.init_mlstm,
                SLSTM: L.init_slstm}.get(spec.mixer)
        if init is None:
            raise ValueError(spec.mixer)
        self.mixer = ParamDict(init(cfg, dtype, device, generator))
        if spec.mixer in (MLSTM, SLSTM):
            # the parameters a split of n ranks gathers whole
            self.mixer.whole = functools.partial(L.whole_params, spec.mixer,
                                                 cfg)
        if spec.cross_attn:
            self.norm_cross = ParamDict(L.init_norm(cfg, dtype, device))
            self.cross = ParamDict(L.init_attention(cfg, dtype, device,
                                                    generator))
        if spec.ffn == DENSE_FFN:
            self.norm2 = ParamDict(L.init_norm(cfg, dtype, device))
            self.ffn = ParamDict(L.init_ffn(cfg, dtype, device, generator))
        elif spec.ffn == MOE_FFN:
            self.norm2 = ParamDict(L.init_norm(cfg, dtype, device))
            self.ffn = ParamDict(L.init_moe(cfg, dtype, device, generator))
        elif spec.ffn != NO_FFN:
            raise ValueError(spec.ffn)

    def cache_len(self, seq_len: int) -> int:
        if self.window is not None:
            return min(self.window, seq_len)
        return seq_len

    def init_cache(self, batch: int, seq_len: int, dtype, device,
                   enc_len: int = 0) -> Cache:
        """This block's zeroed cache: k/v ``[B, cache_len, Hkv, hd]`` for
        attention (a ring of ``min(window, seq_len)`` slots when
        windowed), else the recurrent state of the JAX package's
        ``init_block_cache``; with cross-attention also ``cross_k`` /
        ``cross_v`` ``[B, Hkv, enc_len, hd]`` (head-major, where the JAX
        package keeps ``[B, enc_len, Hkv, hd]``)."""
        cfg = self.cfg
        f32 = dict(dtype=torch.float32, device=device)
        kind = self.spec.mixer
        if kind == RGLRU:
            dr = cfg.d_rnn or cfg.d_model
            c = {"h": torch.zeros((batch, dr), **f32),
                 "conv": torch.zeros((batch, cfg.conv_width - 1, dr),
                                     dtype=dtype, device=device)}
        elif kind == MLSTM:
            hd = 2 * cfg.d_model // cfg.n_heads
            c = {"C": torch.zeros((batch, cfg.n_heads, hd, hd), **f32),
                 "n": torch.zeros((batch, cfg.n_heads, hd), **f32),
                 "m": torch.full((batch, cfg.n_heads), -1e30, **f32)}
        elif kind == SLSTM:
            D = cfg.d_model
            c = {"c": torch.zeros((batch, D), **f32),
                 "n": torch.ones((batch, D), **f32),
                 "h": torch.zeros((batch, D), **f32),
                 "m": torch.zeros((batch, D), **f32)}
        else:
            shape = (batch, self.cache_len(seq_len), cfg.n_kv_heads, cfg.hd)
            c = {n: torch.zeros(shape, dtype=dtype, device=device)
                 for n in ("k", "v")}
        if self.spec.cross_attn:
            shape = (batch, cfg.n_kv_heads, enc_len, cfg.hd)
            c.update({n: torch.zeros(shape, dtype=dtype, device=device)
                      for n in ("cross_k", "cross_v")})
        return c

    def _recurrent(self, h, state=None, ac=None):
        """The recurrent mixer over ``h``: (y, new state).  The layer is
        looked up at the call, so that a harness can patch it.  On a
        split mesh the RG-LRU splits its channels, the mLSTM and the
        sLSTM their heads (:meth:`state_dims`)."""
        layer = {RGLRU: L.rglru, MLSTM: L.mlstm,
                 SLSTM: L.slstm}[self.spec.mixer]
        if ac is None:
            return layer(h, self.mixer.p, self.cfg, state)
        return layer(h, self.mixer.p, self.cfg, state, ac=ac)

    def state_dims(self, ac) -> Dict[str, object]:
        """The layout over ``model`` of each recurrent state tensor as the
        mixer computes it (None: whole;
        :meth:`~repro_torch.parallel.split.ModelSplit.relayout`): the
        RG-LRU's channels where the split divides them, the mLSTM's and
        the sLSTM's heads (:func:`~repro_torch.models.layers.
        state_layouts`)."""
        keys = STATE_KEYS[self.spec.mixer]
        if ac is None:
            return dict.fromkeys(keys)
        if self.spec.mixer != RGLRU:
            return L.state_layouts(self.spec.mixer, self.cfg, ac.n)
        split = (self.cfg.d_rnn or self.cfg.d_model) % ac.n == 0
        dims = {"h": 1, "conv": 2} if split else {}
        return {n: dims.get(n) for n in keys}

    def cache_dims(self, ac) -> Dict[str, object]:
        """The layout over ``model`` of each cache tensor that
        :meth:`prefill` returns (None: whole): kv heads where the split
        divides them, the recurrent states as :meth:`state_dims` says."""
        if self.spec.mixer in STATE_KEYS:
            dims = self.state_dims(ac)
        else:
            heads = 2 if ac is not None and \
                self.cfg.n_kv_heads % ac.n == 0 else None
            dims = {"k": heads, "v": heads}
        if self.spec.cross_attn:
            heads = 1 if ac is not None and \
                self.cfg.n_kv_heads % ac.n == 0 else None
            dims.update(cross_k=heads, cross_v=heads)
        return dims

    def _cross(self, x, k, v, ac=None, kv_split=None):
        """x plus the cross-attention on an encoder's k/v ``[B, Hkv,
        S_enc, hd]``."""
        h = L.apply_norm(x, self.norm_cross.p, self.cfg)
        if ac is None:
            return x + L.cross_attention(h, self.cross.p, self.cfg, k, v)
        return x + L.cross_attention(h, self.cross.p, self.cfg, k, v, ac,
                                     kv_split)

    def _ffn(self, x, aux: Optional[list] = None, ac=None):
        """x plus the FFN; a MoE block appends its load-balancing loss to
        ``aux`` when given.  On a mesh the MoE takes the executor's view
        of the batch's rows (:meth:`~repro_torch.parallel.executor.
        MeshExecutor.moe_rows`: the global dispatch routes every token of
        the batch, as on one device, the grouped one each row on its
        rank), on its sequence gathered where ``model`` splits it."""
        if self.spec.ffn == NO_FFN:
            return x
        h = L.apply_norm(x, self.norm2.p, self.cfg)
        if self.spec.ffn == DENSE_FFN:
            return x + L.ffn(h, self.ffn.p, self.cfg, ac)
        ex = self.executor
        if ac is not None:
            h = ac(h, "mm_input")
        # the mesh's rows where there are any (a harness patches the
        # one-device layers with their own arguments)
        on = () if ex is None else (ex.moe_rows(),)
        if aux is not None:
            aux.append(L.moe_aux_loss(h, self.ffn.p, self.cfg, *on))
        y = L.moe_ffn(h, self.ffn.p, self.cfg, ac, *on)
        if ac is not None and ac.seq:
            y = ac.own(y, 1)
        return x + y

    def forward_train(self, x, positions, enc_out=None, ac=None):
        """The block over a whole training sequence, with autograd:
        returns (x, the MoE load-balancing loss or None).  The reference's
        ``block_apply``."""
        h = L.apply_norm(x, self.norm1.p, self.cfg)
        if self.spec.mixer in STATE_KEYS:
            y, _ = self._recurrent(h, ac=ac)
        else:
            y, _, _ = L.attention(h, self.mixer.p, self.cfg,
                                  window=self.window, positions=positions,
                                  ac=ac)
        x = x + y
        if self.spec.cross_attn and enc_out is not None:
            x = self._cross(x, *L.cross_kv(enc_out, self.cross.p, self.cfg,
                                           ac), ac)
        aux: list = []
        x = self._ffn(x, aux, ac)
        return x, (aux[0] if aux else None)

    def encode(self, x, positions, ac=None):
        """An encoder block over the whole input: bidirectional attention
        and the FFN; no cache."""
        h = L.apply_norm(x, self.norm1.p, self.cfg)
        y, _, _ = L.attention(h, self.mixer.p, self.cfg, causal=False,
                              positions=positions, ac=ac)
        return self._ffn(x + y, ac=ac)

    def prefill(self, x, positions, cache_len: int, enc_out=None, ac=None):
        """The block over the full prompt, and cross-attention on
        ``enc_out [B, S_enc, D]`` where the block has it and an encoder
        output is given; returns (x, filled cache), the cache split as
        :meth:`cache_dims` says."""
        cfg = self.cfg
        h = L.apply_norm(x, self.norm1.p, cfg)
        if self.spec.mixer in STATE_KEYS:
            y, state = self._recurrent(h, ac=ac)
            # copies of strided views (the conv tail, the mLSTM's n), so
            # that the cache does not hold the tensors they slice
            cache = {n: t.contiguous() for n, t in state.items()}
        else:
            y, k, v = L.attention(h, self.mixer.p, cfg, window=self.window,
                                  positions=positions, ac=ac)
            S = k.shape[1]  # the whole prompt (x is a slice of it under SP)
            if cache_len >= S:
                pad = (0, 0, 0, 0, 0, cache_len - S)
                k, v = torch.nn.functional.pad(k, pad), \
                    torch.nn.functional.pad(v, pad)
            else:  # windowed ring cache keeps the tail; slot p % cache_len
                start = S - cache_len
                k = torch.roll(k[:, start:], shifts=S % cache_len, dims=1)
                v = torch.roll(v[:, start:], shifts=S % cache_len, dims=1)
            cache = {"k": k.contiguous(), "v": v.contiguous()}
        x = x + y
        if self.spec.cross_attn and enc_out is not None:
            ck, cv = L.cross_kv(enc_out, self.cross.p, cfg, ac)
            x = self._cross(x, ck, cv, ac)
            cache.update(cross_k=ck, cross_v=cv)
        return self._ffn(x, ac=ac), cache

    def decode(self, x, cache: Cache, pos: int, ac=None, dims=None):
        """One token; writes its k/v, or the new recurrent state, into
        ``cache`` in place.  On a split mesh ``dims`` gives the dim of
        each cache tensor that is split over ``model`` (None: whole): the
        attention reads its cache as it is split, a recurrent state is
        cut to the mixer's split for the step and back."""
        dims = dims or {}
        h = L.apply_norm(x, self.norm1.p, self.cfg)
        keys = STATE_KEYS.get(self.spec.mixer)
        if keys is not None:
            want = self.state_dims(ac)
            relayout = (lambda t, a, b: t) if ac is None else ac.relayout
            y, state = self._recurrent(
                h, {n: relayout(cache[n], dims.get(n), want[n])
                    for n in keys}, ac)
            for n in keys:
                cache[n].copy_(relayout(state[n], want[n], dims.get(n)))
        else:
            y, cache = L.attention_decode(h, self.mixer.p, self.cfg, cache,
                                          pos, window=self.window, ac=ac,
                                          kv_split=dims.get("k"))
        x = x + y
        if self.spec.cross_attn:
            x = self._cross(x, cache["cross_k"], cache["cross_v"], ac,
                            dims.get("cross_k"))
        return self._ffn(x, ac=ac), cache


#: the encoder's block: bidirectional attention and a dense FFN
ENCODER_SPEC = BlockSpec(mixer=ATTN, ffn=DENSE_FFN)


class Encoder(nn.Module):
    """The encoder of an encoder–decoder model: ``cfg.enc_layers`` blocks
    of ``ENCODER_SPEC``, each attending over the whole input (no mask),
    then the final norm.  Port of the JAX package's ``params["enc"]``
    with ``_apply_groups(causal=False)``."""

    #: the mesh executor (see :class:`Model`)
    executor = None

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            Block(cfg, ENCODER_SPEC, dtype, device, generator)
            for _ in range(cfg.enc_layers))
        self.final_norm = ParamDict(L.init_norm(cfg, dtype, device))

    def forward(self, x, remat: bool = False):
        """x [B, S_enc, D] (the projected frames) -> the encoder's output
        [B, S_enc, D]; RoPE over positions ``0 .. S_enc - 1``.  With
        ``remat`` each block is recomputed in the backward pass.  On a
        split mesh under SP the residual holds this rank's slice of the
        frames, and the output is gathered whole."""
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        ex = self.executor
        ac = _split_at(ex, x.shape[1])
        if ac is not None and ac.seq:
            x = ac.own(x, 1)
        for blk in self.blocks:
            x = checkpoint(_call, ex, blk, blk.encode, x, positions, ac,
                           use_reentrant=False) \
                if remat else _call(ex, blk, blk.encode, x, positions, ac)
        with _gathered(ex, self.final_norm):
            x = L.apply_norm(x, self.final_norm.p, self.cfg)
        return ac.gather(x, 1) if ac is not None and ac.seq else x


class Model(nn.Module):
    """A model of ``cfg`` with parameters drawn from ``generator`` (normal,
    the JAX package's scales) on ``device``: a decoder, and an
    :class:`Encoder` (``enc``) where ``cfg.encoder_decoder``."""

    #: the mesh executor: None on one device
    executor = None

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        dtype = _dtype(cfg.param_dtype)
        self.cfg = cfg
        s = 1.0 / math.sqrt(cfg.d_model)
        self.embed = nn.Parameter(L.normal(
            (cfg.padded_vocab, cfg.d_model), s, dtype, device, generator))
        self.final_norm = ParamDict(L.init_norm(cfg, dtype, device))
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            L.normal((cfg.d_model, cfg.padded_vocab), s, dtype, device,
                     generator))
        self.frontend = None if cfg.frontend == "none" else ParamDict(
            {"proj": L.normal((cfg.d_model, cfg.d_model), s, dtype, device,
                              generator)})
        self.blocks = nn.ModuleList(
            Block(cfg, spec, dtype, device, generator)
            for spec in cfg.blocks())
        self.enc = Encoder(cfg, dtype, device, generator) \
            if cfg.encoder_decoder else None
        #: the layer group of each block (``cfg.layer_groups``, in the
        #: order of ``cfg.blocks()``): the MoE loss sums over a group
        self.group_of = [g for g, (repeat, body) in
                         enumerate(cfg.layer_groups)
                         for _ in range(repeat * len(body))]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return _dtype(self.cfg.compute_dtype)

    # -- embedding / logits ------------------------------------------------
    def _embed(self, tokens):
        """The tokens' embeddings; where the table's vocab rows are split
        over ``model``, each rank looks up the tokens of its rows (zeros
        for the others) and the lookups are summed over ``model``."""
        ac = _split_at(self.executor, 0)
        with _gathered(self.executor, self, ("embed",)):
            V_local = self.embed.shape[0]
            if ac is None or V_local == self.cfg.padded_vocab:
                return self.embed[tokens].to(self.compute_dtype)
            local = tokens.long() - ac.index * V_local
            inside = (local >= 0) & (local < V_local)
            e = self.embed[local.clamp(0, V_local - 1)] \
                * inside[..., None].to(self.embed.dtype)
        return ac.sum(e.to(self.compute_dtype))

    def _logits(self, x):
        """f32 logits over the padded vocab (:func:`head_logits`): this
        rank's slice of it where the head's vocab is split over ``model``
        and ``pcfg.shard_logits`` holds, else whole."""
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        ex = self.executor
        with _gathered(ex, self, (name,)):
            w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
            return head_logits(x, w, _split_at(ex, 0),
                               self.cfg.padded_vocab,
                               ex is None or ex.rules.pcfg.shard_logits)

    def _final_norm(self, x):
        with _gathered(self.executor, self.final_norm):
            return L.apply_norm(x, self.final_norm.p, self.cfg)

    def _assemble_input(self, batch):
        """tokens (+ stub-frontend embeds, prepended, except in an
        encoder–decoder model, whose frontend feeds the encoder) -> (x
        [B,S,D], positions, loss mask [B,S] f32: 0 on the frontend's
        positions, 1 on the text)."""
        tokens = batch["tokens"]
        x = self._embed(tokens)
        B, S_text = tokens.shape
        ones = torch.ones((B, S_text), dtype=torch.float32, device=x.device)
        if self.frontend is not None and "embeds" in batch \
                and not self.cfg.encoder_decoder:
            with _gathered(self.executor, self.frontend):
                e = batch["embeds"].to(x.dtype) @ self.frontend.p["proj"] \
                    .to(x.dtype)
            e = _whole_columns(_split_at(self.executor, 0), e,
                               self.cfg.d_model)
            x = torch.cat([e, x], dim=1)
            mask = torch.cat([torch.zeros((B, e.shape[1]),
                                          dtype=torch.float32,
                                          device=x.device), ones], dim=1)
        else:
            mask = ones
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        return x, positions, mask

    # -- caches ------------------------------------------------------------
    def init_caches(self, batch: int, seq_len: int,
                    enc_len: int = 0) -> List[Cache]:
        """Zeroed caches, one per block (:meth:`Block.init_cache`)."""
        return [blk.init_cache(batch, seq_len, self.compute_dtype,
                               self.device, enc_len)
                for blk in self.blocks]

    # -- training --------------------------------------------------------
    def _encoder_out(self, enc_embeds, remat: bool = False):
        dt = self.compute_dtype
        with _gathered(self.executor, self.frontend):
            e = enc_embeds.to(dt) @ self.frontend.p["proj"].to(dt)
        e = _whole_columns(_split_at(self.executor, 0), e, self.cfg.d_model)
        return self.enc(e, remat)

    def train_terms(self, batch, *, remat: bool = True):
        """The parts of :meth:`forward_train`'s loss: the sum of the
        next-token negative log-likelihoods over the text region (f32,
        with its graph), the number of labels summed, and the MoE
        load-balancing loss of each layer group (the sum of its blocks';
        an empty list without MoE).  With ``remat`` each block (and each
        encoder block) is recomputed in the backward pass."""
        enc_out = None
        if self.enc is not None:
            enc_out = self._encoder_out(batch["enc_embeds"], remat)
        x, positions, mask = self._assemble_input(batch)
        groups = [[] for _ in self.cfg.layer_groups] \
            if self.cfg.moe is not None else None
        ex = self.executor
        ac = _split_at(ex, x.shape[1])
        if ac is not None and ac.seq:
            x = ac.own(x, 1)
        for blk, g in zip(self.blocks, self.group_of):
            x, aux = checkpoint(_call, ex, blk, blk.forward_train, x,
                                positions, enc_out, ac,
                                use_reentrant=False) \
                if remat else _call(ex, blk, blk.forward_train, x,
                                    positions, enc_out, ac)
            if groups is not None and aux is not None:
                groups[g].append(aux)
        x = self._final_norm(x)
        if ac is not None and ac.seq:
            x = ac.gather(x, 1)
        tokens = batch["tokens"]
        F = x.shape[1] - tokens.shape[1]
        logits = self._logits(x[:, F:][:, :-1])          # [B, S-1, Vp] f32
        labels = tokens[:, 1:].long()
        lmask = mask[:, F + 1:]
        nll = token_nll(logits, labels, ac, self.cfg.padded_vocab)
        per_group = [torch.stack(a).sum() if a else
                     torch.zeros((), device=nll.device)
                     for a in groups or ()]
        return (nll * lmask).sum(), lmask.sum(), per_group

    def forward_train(self, batch, *, remat: bool = True):
        """Next-token cross-entropy over the text region (+ 0.01 times the
        MoE load-balancing loss), a scalar f32 with its graph.  batch:
        ``{"tokens": [B,S]}`` plus ``"embeds"`` for the patch frontend /
        ``"enc_embeds"`` for an encoder–decoder model.  The reference's
        ``forward_train`` (:meth:`train_terms`).

        The MoE term is the reference's: one entry per layer group, the
        sum of its blocks' losses, and ``0.01 * sum / n_groups`` (a sum
        over the layers of a one-group model, not a mean)."""
        nll, count, per_group = self.train_terms(batch, remat=remat)
        loss = nll / torch.clamp(count, min=1.0)
        if per_group:
            loss = loss + 0.01 * sum(per_group) / len(per_group)
        return loss

    # -- serving entry points ----------------------------------------------
    @torch.no_grad()
    def encode(self, enc_embeds):
        """The encoder's output ``[B, S_enc, D]`` of the frame embeddings
        ``enc_embeds [B, S_enc, D]`` (through the frontend's projection)."""
        return self._encoder_out(enc_embeds)

    @torch.no_grad()
    def prefill(self, batch, *, cache_len: Optional[int] = None,
                enc_out=None):
        """Process a full prompt; returns (last-position logits [B,1,Vp]
        f32, caches).  An encoder–decoder model runs its encoder over
        ``batch["enc_embeds"]`` unless ``enc_out`` (:meth:`encode`) is
        given, and its blocks' caches keep the cross k/v."""
        x, positions, _ = self._assemble_input(batch)
        if self.enc is not None and enc_out is None \
                and "enc_embeds" in batch:
            enc_out = self.encode(batch["enc_embeds"])
        S = x.shape[1]
        cache_len = cache_len or S
        ac = _split_at(self.executor, S)
        if ac is not None and ac.seq:
            x = ac.own(x, 1)
        caches = []
        for blk in self.blocks:
            x, c = _call(self.executor, blk, blk.prefill, x, positions,
                         blk.cache_len(cache_len), enc_out, ac)
            caches.append(c)
        x = self._final_norm(x)
        if ac is not None and ac.seq:
            x = ac.gather(x, 1)
        return self._logits(x[:, -1:, :]), caches

    def cache_dims(self) -> List[Dict[str, Optional[int]]]:
        """For each block, the dim of each cache tensor that
        :meth:`prefill` returns split over ``model`` (None: whole; all
        None without a split)."""
        ac = _split_at(self.executor, 0)
        return [blk.cache_dims(ac) for blk in self.blocks]

    @torch.no_grad()
    def decode_step(self, tokens, caches: List[Cache], pos: int,
                    dims=None):
        """One decode step.  tokens: [B,1]; pos: the number of tokens
        already in the cache.  Returns (logits [B,1,Vp] f32, caches), the
        caches updated in place.  On a split mesh ``dims`` gives, for
        each block, the dim of each cache tensor split over ``model``
        (None: whole), and the logits are this rank's vocab slice."""
        ac = _split_at(self.executor, 1)
        x = self._embed(tokens)
        for i, (blk, c) in enumerate(zip(self.blocks, caches)):
            x, _ = _call(self.executor, blk, blk.decode, x, c, int(pos), ac,
                         dims[i] if dims is not None else None)
        x = self._final_norm(x)
        return self._logits(x), caches

