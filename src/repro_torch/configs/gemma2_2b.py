"""gemma2-2b — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256,
sliding window 4096 on local layers, attn softcap 50, final softcap 30,
pre+post block norms, scaled + tied embeddings.
"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "gemma2-2b"


def build() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        d_ff=9216,
        vocab_size=256000,
        head_dim=256,
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_block_norm=True,
        scale_embeddings=True,
        tie_embeddings=True,
        ffn_kind="swiglu",
        block_pattern=("attn_local", "attn_global"),
    )
