"""codeqwen1.5-7b — dense MHA (kv=32) [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416 — qwen1.5 arch.
"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "codeqwen1.5-7b"


def build() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        qkv_bias=True,
        rope_theta=1e6,
        ffn_kind="swiglu",
        block_pattern=("attn",),
    )
