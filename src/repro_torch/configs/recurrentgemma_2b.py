"""recurrentgemma-2b — Griffin-style hybrid: RG-LRU + local attention, 1:2
attention:recurrence ratio [arXiv:2402.19427].

26L, d_model 2560, 10H (GQA kv=1), d_ff 7680, vocab 256000, d_rnn 2560,
local-attention window 2048.  Pattern: (rglru, rglru, local_attn) × 8 plus
a (rglru, rglru) tail = 26 layers.  Sub-quadratic → long_500k runs with
recurrent state + windowed cache.
"""
from . import register, register_smoke
from .base import DENSE_FFN, RGLRU, SWA, BlockSpec, ModelConfig

_REC = BlockSpec(mixer=RGLRU, ffn=DENSE_FFN)
_LOC = BlockSpec(mixer=SWA, ffn=DENSE_FFN)


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        layer_groups=((8, (_REC, _REC, _LOC)), (1, (_REC, _REC))),
        window=2048,
        d_rnn=2560,
        conv_width=4,
        rope_theta=10000.0,
        tie_embeddings=True,
        act="gelu",
        subquadratic=True,
    )


@register_smoke("recurrentgemma-2b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        layer_groups=((1, (_REC, _REC, _LOC)), (1, (_REC, _REC))),
        window=16,
        d_rnn=64,
        conv_width=4,
        tie_embeddings=True,
        act="gelu",
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=True,
    )
