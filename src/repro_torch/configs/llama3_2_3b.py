"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-3B].

28L, d_model 3072, 24H (GQA kv=8), d_ff 8192, vocab 128256, tied embeddings.
"""
from . import register, register_smoke
from .base import ATTN, DENSE_FFN, BlockSpec, ModelConfig

_BLOCK = BlockSpec(mixer=ATTN, ffn=DENSE_FFN)


@register("llama3.2-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        layer_groups=((28, (_BLOCK,)),),
        rope_theta=500000.0,
        tie_embeddings=True,
        subquadratic=False,
    )


@register_smoke("llama3.2-3b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        layer_groups=((2, (_BLOCK,)),),
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=False,
    )
