"""mixtral-8x22b — sparse MoE with SWA [arXiv:2401.04088].

56L, d_model 6144, 48H (GQA kv=8), d_ff 16384/expert, vocab 32768,
8 experts top-2, sliding window 4096 → long_500k runs.

EP note (DESIGN.md §5): 8 experts don't divide the 16-wide `model` axis, so
the production plan shards each expert's d_ff over `model` (expert-TP) and
stacks experts; true all-to-all EP is exercised on divisible test meshes.
"""
from . import register, register_smoke
from .base import MOE_FFN, SWA, BlockSpec, ModelConfig, MoECfg

_BLOCK = BlockSpec(mixer=SWA, ffn=MOE_FFN)


@register("mixtral-8x22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        layer_groups=((56, (_BLOCK,)),),
        window=4096,
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=16384),
        rope_theta=1000000.0,
        opt_state_dtype="bfloat16",
        subquadratic=True,
    )


@register_smoke("mixtral-8x22b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        layer_groups=((2, (_BLOCK,)),),
        window=16,
        moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=128),
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=True,
    )
