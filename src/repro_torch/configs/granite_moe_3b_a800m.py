"""granite-moe-3b-a800m — fine-grained MoE
[hf:ibm-granite/granite-3.0-3b-a800m-base].

32L, d_model 1536, 24H (GQA kv=8), d_ff 512/expert, vocab 49155,
MoE 40 experts top-8.  Full attention → long_500k skipped.
"""
from . import register, register_smoke
from .base import ATTN, MOE_FFN, BlockSpec, ModelConfig, MoECfg

_BLOCK = BlockSpec(mixer=ATTN, ffn=MOE_FFN)


@register("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        layer_groups=((32, (_BLOCK,)),),
        moe=MoECfg(n_experts=40, top_k=8, d_ff_expert=512),
        rope_theta=10000.0,
        tie_embeddings=True,
        subquadratic=False,
    )


@register_smoke("granite-moe-3b-a800m")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke",
        family="moe",
        n_layers=2,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        d_ff=32,
        vocab_size=512,
        layer_groups=((2, (_BLOCK,)),),
        moe=MoECfg(n_experts=8, top_k=4, d_ff_expert=32),
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=False,
    )
