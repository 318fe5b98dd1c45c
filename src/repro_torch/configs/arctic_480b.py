"""arctic-480b — dense-MoE hybrid: 128 experts top-2 + dense residual FFN
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
The dense residual branch runs in parallel with the routed experts.
"""

from repro_torch.models.common import ModelConfig, MoEConfig

ARCH_ID = "arctic-480b"


def build() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        rope_theta=1e6,
        ffn_kind="swiglu",
        moe=MoEConfig(
            num_experts=128,
            top_k=2,
            d_ff_expert=4864,
            dense_residual=True,
        ),
        block_pattern=("attn",),
    )
