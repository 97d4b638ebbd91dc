"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L, d_model 768, 4H (kv=4), vocab 50304, no separate FFN (d_ff=0; xLSTM
blocks carry internal up/down projections).  Alternating (mlstm, slstm) × 6.
Recurrent state only → long_500k runs (no KV cache at all).
"""
from . import register, register_smoke
from .base import MLSTM, NO_FFN, SLSTM, BlockSpec, ModelConfig

_M = BlockSpec(mixer=MLSTM, ffn=NO_FFN)
_S = BlockSpec(mixer=SLSTM, ffn=NO_FFN)


@register("xlstm-125m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        layer_groups=((6, (_M, _S)),),
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=True,
    )


@register_smoke("xlstm-125m")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        layer_groups=((1, (_M, _S)),),
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=True,
    )
