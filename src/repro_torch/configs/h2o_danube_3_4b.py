"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].

24L, d_model 3840, 32H (GQA kv=8), d_ff 10240, vocab 32000.  SWA window
4096 → sub-quadratic, so long_500k runs with a ring-buffer KV cache.
"""
from . import register, register_smoke
from .base import DENSE_FFN, SWA, BlockSpec, ModelConfig

_BLOCK = BlockSpec(mixer=SWA, ffn=DENSE_FFN)


@register("h2o-danube-3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        layer_groups=((24, (_BLOCK,)),),
        window=4096,
        rope_theta=10000.0,
        subquadratic=True,
    )


@register_smoke("h2o-danube-3-4b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        layer_groups=((2, (_BLOCK,)),),
        window=16,
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=True,
    )
