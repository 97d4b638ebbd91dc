"""internvl2-2b — VLM: InternViT frontend (STUB) + InternLM2 backbone
[arXiv:2404.16821].

Backbone: 24L, d_model 2048, 16H (GQA kv=8), d_ff 8192, vocab 92553.
The ViT frontend is a stub per the assignment: ``input_specs()`` provides
precomputed patch embeddings (256 image tokens) that are prepended to the
text sequence.
"""
from . import register, register_smoke
from .base import ATTN, DENSE_FFN, BlockSpec, ModelConfig

_BLOCK = BlockSpec(mixer=ATTN, ffn=DENSE_FFN)


@register("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        layer_groups=((24, (_BLOCK,)),),
        rope_theta=1000000.0,
        frontend="patch",
        frontend_tokens=256,
        subquadratic=False,
    )


@register_smoke("internvl2-2b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        layer_groups=((2, (_BLOCK,)),),
        frontend="patch",
        frontend_tokens=8,
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=False,
    )
