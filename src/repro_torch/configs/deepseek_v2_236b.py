"""deepseek-v2-236b — MLA attention + fine-grained MoE [arXiv:2405.04434].

60L d_model=5120 128H d_ff=1536 vocab=102400, MoE 160e top-6, 2 shared
experts, MLA kv_lora=512 (qk_nope=128, qk_rope=64, v=128, q_lora=1536).
First layer is dense.
"""

from repro_torch.models.common import ModelConfig, MoEConfig

ARCH_ID = "deepseek-v2-236b"


def build() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=1536,
        vocab_size=102400,
        attention_kind="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        ffn_kind="swiglu",
        first_k_dense=1,
        moe=MoEConfig(
            num_experts=160,
            top_k=6,
            d_ff_expert=1536,
            num_shared_experts=2,
        ),
        block_pattern=("attn",),
    )
