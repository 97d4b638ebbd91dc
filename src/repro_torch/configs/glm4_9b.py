"""glm4-9b — dense GQA transformer with aggressive KV compression (kv=2)
[hf:THUDM/glm-4-9b].

40L, d_model 4096, 32H (GQA kv=2), d_ff 13696, vocab 151552.
"""
from . import register, register_smoke
from .base import ATTN, DENSE_FFN, BlockSpec, ModelConfig

_BLOCK = BlockSpec(mixer=ATTN, ffn=DENSE_FFN)


@register("glm4-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=151552,
        layer_groups=((40, (_BLOCK,)),),
        rope_theta=10000.0,
        subquadratic=False,
    )


@register_smoke("glm4-9b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        layer_groups=((2, (_BLOCK,)),),
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=False,
    )
