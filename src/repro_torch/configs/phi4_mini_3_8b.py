"""phi4-mini-3.8b — dense GQA transformer [arXiv:2412.08905; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.
"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "phi4-mini-3.8b"


def build() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        rope_theta=10000.0,
        ffn_kind="swiglu",
        block_pattern=("attn",),
    )
