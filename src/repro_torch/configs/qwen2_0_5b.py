"""qwen2-0.5b — dense GQA transformer with QKV bias [arXiv:2407.10671; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "qwen2-0.5b"


def build() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1e6,
        ffn_kind="swiglu",
        block_pattern=("attn",),
    )
