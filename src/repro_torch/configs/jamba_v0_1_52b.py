"""jamba-v0.1-52b — Mamba + attention 1:7 interleave with MoE
[arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2 on
every 2nd layer.  8-layer super-block: attention at offset 4, Mamba
elsewhere.  Hybrid: the ``long_500k`` cell runs here (Mamba state is O(1);
the 4 attention layers keep a seq-sharded KV cache).
"""

from repro_torch.models.common import ModelConfig, MoEConfig

ARCH_ID = "jamba-v0.1-52b"


def build() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        ffn_kind="swiglu",
        use_rope=False,          # Jamba uses no positional encoding
        moe=MoEConfig(
            num_experts=16,
            top_k=2,
            d_ff_expert=14336,
            every_k_layers=2,
        ),
        ssm_state_dim=16,
        ssm_conv_width=4,
        ssm_expand=2,
        block_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
    )
