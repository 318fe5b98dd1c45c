"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (MHA) d_ff=8192 vocab=2048.  Backbone only: the
EnCodec frontend is a stub — ``input_specs()`` provides precomputed frame
embeddings (B, S, d_model).  Sinusoidal absolute positions (no RoPE),
GELU FFN.
"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "musicgen-large"


def build() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        use_rope=False,
        ffn_kind="gelu",
        frontend_stub=True,
        block_pattern=("attn",),
    )
