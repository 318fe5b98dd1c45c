"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  Backbone only:
the vision tower is a stub — ``input_specs()`` provides precomputed patch
embeddings plus (3, B, S) t/h/w position streams for M-RoPE
(sections 16/24/24 over the 64 half-dim frequencies).
"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "qwen2-vl-2b"


def build() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        head_dim=128,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1e6,
        mrope_sections=(16, 24, 24),
        ffn_kind="swiglu",
        frontend_stub=True,
        block_pattern=("attn",),
    )
