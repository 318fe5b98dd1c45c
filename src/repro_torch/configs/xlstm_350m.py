"""xlstm-350m — sLSTM + mLSTM recurrent blocks [arXiv:2405.04517].

24L d_model=1024 4H d_ff=0 vocab=50304.  Blocks alternate mLSTM (parallel
matrix-memory) and sLSTM (sequential scalar-memory); no external FFN
(projections live inside the blocks).  Attention-free: the ``long_500k``
cell runs on this arch (O(1) decode state).
"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "xlstm-350m"


def build() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        tie_embeddings=True,
        block_pattern=("mlstm", "slstm"),
    )
