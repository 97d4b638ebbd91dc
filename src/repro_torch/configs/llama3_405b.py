"""llama3-405b — dense GQA transformer [arXiv:2407.21783].

126L, d_model 16384, 128 heads (GQA kv=8), d_ff 53248, vocab 128256.
Pure full attention → long_500k is skipped (quadratic).  Optimizer states
run in bf16 so 405B fits a single 256-chip v5e pod (see DESIGN.md §5).
"""
from . import register, register_smoke
from .base import ATTN, DENSE_FFN, BlockSpec, ModelConfig

_BLOCK = BlockSpec(mixer=ATTN, ffn=DENSE_FFN)


@register("llama3-405b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        layer_groups=((126, (_BLOCK,)),),
        rope_theta=500000.0,
        opt_state_dtype="bfloat16",
        subquadratic=False,
    )


@register_smoke("llama3-405b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        layer_groups=((2, (_BLOCK,)),),
        rope_theta=500000.0,
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=False,
    )
