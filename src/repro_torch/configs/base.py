"""Config system: model architecture + input-shape + parallelism configs
(the port's own copy of the JAX package's ``configs/base.py``, equal field
for field).

Every assigned architecture is expressed as a :class:`ModelConfig` built
from *layer groups*: ``[(repeat, [BlockSpec, ...]), ...]``.  A group's body
is a fixed sequence of blocks repeated ``repeat`` times — this supports
homogeneous stacks (llama: 1-block body), interleaved patterns
(recurrentgemma: [rglru, rglru, local_attn] × 8 + a tail), and alternating
patterns (xlstm: [mlstm, slstm] × 6).  The JAX package stacks each group
for ``lax.scan``; the port's :class:`~repro_torch.models.model.Model` holds
the blocks in a plain ``ModuleList``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

# mixer kinds
ATTN = "attn"            # full (causal for LM) GQA attention
SWA = "swa"              # sliding-window GQA attention
RGLRU = "rglru"          # RG-LRU recurrence (+ temporal conv)
MLSTM = "mlstm"          # matrix-LSTM (linear attention w/ forget gates)
SLSTM = "slstm"          # scalar-LSTM
CROSS_ATTN = "cross"     # decoder cross-attention (enc-dec only)

# ffn kinds
DENSE_FFN = "dense"
MOE_FFN = "moe"
NO_FFN = "none"


@dataclass(frozen=True)
class BlockSpec:
    mixer: str = ATTN
    ffn: str = DENSE_FFN
    # whisper decoder blocks carry self-attn AND cross-attn
    cross_attn: bool = False


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # capacity factor for dispatch (tokens per expert = factor * T*k/E)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_groups: Tuple[Tuple[int, Tuple[BlockSpec, ...]], ...]
    head_dim: Optional[int] = None
    window: Optional[int] = None      # SWA / local-attention window
    moe: Optional[MoECfg] = None
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | gelu
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    # recurrent-block dims
    d_rnn: Optional[int] = None       # RG-LRU width (recurrentgemma: 2560)
    conv_width: int = 4
    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    enc_layers: int = 0
    enc_groups: Tuple = ()
    # modality frontend stub: none | patch | audio
    frontend: str = "none"
    frontend_tokens: int = 0          # image/audio tokens prepended (stub)
    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # optimizer-state dtype (405b uses bf16 to fit 256 chips — see DESIGN.md)
    opt_state_dtype: str = "float32"
    # long-context capability: sub-quadratic attention available?
    subquadratic: bool = False
    # embedding/logits vocab rows padded to a multiple of this so the vocab
    # dim shards evenly over the 16-wide `model` axis (MaxText-style)
    vocab_pad: int = 128
    # mLSTM training/prefill implementation: "scan" (per-step, baseline) or
    # "chunked" (stabilized chunked gated linear attention — §Perf)
    mlstm_impl: str = "scan"
    mlstm_chunk: int = 128
    # MoE dispatch: "global" (one sort over all tokens — baseline) or
    # "grouped" (per-batch-row routing; shard-local dispatch — §Perf)
    moe_impl: str = "global"
    # attention backward: "autodiff" (scan VJP saves per-chunk probs —
    # baseline) or "flash" (chunked recompute custom-VJP — §Perf)
    attn_vjp: str = "autodiff"

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + self.vocab_pad - 1)
                // self.vocab_pad) * self.vocab_pad

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def blocks(self) -> List[BlockSpec]:
        out: List[BlockSpec] = []
        for repeat, body in self.layer_groups:
            out.extend(list(body) * repeat)
        return out

    def param_count(self) -> int:
        """Total parameters (analytic; used for roofline MODEL_FLOPS)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top_k experts only)."""
        return _param_count(self, active_only=True)


def _ffn_params(cfg: ModelConfig, spec: BlockSpec, active_only: bool) -> int:
    if spec.ffn == NO_FFN:
        return 0
    if spec.ffn == MOE_FFN:
        m = cfg.moe
        n_mats = 3 if cfg.act == "swiglu" else 2
        per_expert = n_mats * cfg.d_model * m.d_ff_expert
        router = cfg.d_model * m.n_experts
        n_e = m.top_k if active_only else m.n_experts
        return per_expert * n_e + router
    n_mats = 3 if cfg.act == "swiglu" else 2
    return n_mats * cfg.d_model * cfg.d_ff


def _mixer_params(cfg: ModelConfig, spec: BlockSpec) -> int:
    d, hd = cfg.d_model, cfg.hd
    if spec.mixer in (ATTN, SWA):
        q = d * cfg.n_heads * hd
        kv = 2 * d * cfg.n_kv_heads * hd
        o = cfg.n_heads * hd * d
        n = q + kv + o
        if spec.cross_attn:
            n *= 2
        return n
    if spec.mixer == RGLRU:
        dr = cfg.d_rnn or d
        # in/out proj (x2 branches) + gates + conv
        return 2 * d * dr + dr * d + 2 * dr * dr // 8 + cfg.conv_width * dr
    if spec.mixer == MLSTM:
        # qkv + o + gates, with expansion 2
        de = 2 * d
        return d * de * 3 + de * d + 3 * d * de // 4
    if spec.mixer == SLSTM:
        de = d
        return 4 * d * de + de * d * 2
    raise ValueError(spec.mixer)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    n = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model
    for spec in cfg.blocks():
        n += _mixer_params(cfg, spec) + _ffn_params(cfg, spec, active_only)
        n += 2 * cfg.d_model  # norms
    if cfg.encoder_decoder:
        for _ in range(cfg.enc_layers):
            enc_spec = BlockSpec(mixer=ATTN, ffn=DENSE_FFN)
            n += _mixer_params(cfg, enc_spec) + _ffn_params(
                cfg, enc_spec, active_only) + 2 * cfg.d_model
    return n


# ---------------------------------------------------------------------------
# input shapes (assigned per-arch shape set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Whether a cell (arch × shape) runs; reason if skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k decode requires "
                       "sub-quadratic attention (see DESIGN.md)")
    return True, ""


# ---------------------------------------------------------------------------
# parallelism plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelCfg:
    """Logical parallelism axes and knobs; mapped onto a physical mesh by
    repro.parallel.sharding."""
    fsdp_axes: Tuple[str, ...] = ("pod", "data")  # ZeRO-3 + DP axes
    tp_axis: str = "model"
    # gradient accumulation: microbatches per step (activations fit HBM)
    grad_accum: int = 1
    remat: bool = True
    # sequence-parallel residual stream (long-context shapes)
    seq_shard: bool = False
    # decode-cache sharding: "heads" | "seq" (flash-decoding style)
    kv_shard: str = "heads"
    # logits computed vocab-sharded (avoids full-vocab gather)
    shard_logits: bool = True
    # gradient accumulation/reduction dtype; bf16 halves the per-microbatch
    # gradient reduce-scatter volume (production trade-off — §Perf)
    grad_dtype: str = "float32"


def default_parallel(cfg: ModelConfig, shape: ShapeCfg,
                     data_axis: int = 16) -> ParallelCfg:
    """Baseline parallelism plan per cell (the §Perf hillclimb mutates
    these).

    grad_accum is chosen so the microbatch stays divisible by the data
    axis — otherwise GSPMD can't shard the batch dim and silently
    replicates activations (catastrophic all-reduce traffic).
    """
    grad_accum = 1
    n = cfg.param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        if n > 1e11:
            want = 16
        elif n > 1e9 and tokens >= 2 ** 20:
            want = 4
        else:
            want = 1
        # largest accum <= want with microbatch % data_axis == 0
        grad_accum = 1
        for a in (16, 8, 4, 2, 1):
            if a <= want and shape.global_batch % a == 0 \
                    and (shape.global_batch // a) % data_axis == 0:
                grad_accum = a
                break
    # sequence-parallel residual: long-context inference shapes, and
    # 100B+-class training (seq-sharded activation checkpoints keep the
    # per-device carry ~1/16th; Megatron-SP style)
    seq_shard = (shape.kind != "train" and shape.seq_len >= 32768) or \
                (shape.kind == "train" and n > 1e11)
    kv_shard = "seq" if (shape.kind == "decode"
                         and cfg.n_kv_heads < 16) else "heads"
    return ParallelCfg(grad_accum=grad_accum, seq_shard=seq_shard,
                       kv_shard=kv_shard)
