"""whisper-large-v3 — encoder-decoder speech model [arXiv:2212.04356].

32L encoder + 32L decoder, d_model 1280, 20H (MHA kv=20), d_ff 5120,
vocab 51866.  The conv audio frontend is a STUB per the assignment:
``input_specs()`` provides precomputed 1280-d frame embeddings.  Decoder
blocks carry self-attention + cross-attention; decode shapes run the
decoder against cached encoder states.  Full attention → long_500k skipped.
"""
from . import register, register_smoke
from .base import ATTN, DENSE_FFN, BlockSpec, ModelConfig

_DEC = BlockSpec(mixer=ATTN, ffn=DENSE_FFN, cross_attn=True)


@register("whisper-large-v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        layer_groups=((32, (_DEC,)),),
        norm="layernorm",
        act="gelu",
        rope_theta=10000.0,   # (whisper uses learned abs pos; RoPE stands in)
        encoder_decoder=True,
        enc_layers=32,
        frontend="audio",
        subquadratic=False,
    )


@register_smoke("whisper-large-v3")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        layer_groups=((2, (_DEC,)),),
        norm="layernorm",
        act="gelu",
        encoder_decoder=True,
        enc_layers=2,
        frontend="audio",
        param_dtype="float32",
        compute_dtype="float32",
        subquadratic=False,
    )
