"""Model configuration schema shared by all assigned architectures.

One :class:`ModelConfig` describes any of the ten assigned architectures:
dense GQA transformers, MoE variants (top-k routing, shared experts, dense
residual), MLA attention, SSM blocks (Mamba, sLSTM/mLSTM), hybrid
interleaves, and modality-stub backbones (audio / VLM).

Layer stacks are expressed as a repeating **block pattern** (e.g. Jamba's
8-layer ``('mamba',)*4 + ('attn',) + ('mamba',)*3`` unit, Gemma-2's
``('attn_local', 'attn_global')`` unit).  The reference scans over pattern
repeats; the port's :mod:`repro_torch.models.transformer` loops over them.

The port's copy of the reference's ``repro/models/common.py``: plain
dataclasses, no framework.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0       # DeepSeek-V2: always-on experts
    dense_residual: bool = False      # Arctic: dense FFN in parallel w/ MoE
    every_k_layers: int = 1           # Jamba: MoE on every 2nd layer
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # ---- attention ----
    attention_kind: str = "gqa"       # gqa | mla
    qkv_bias: bool = False
    use_rope: bool = True             # False -> sinusoidal absolute pos-emb
    rope_theta: float = 10000.0
    sliding_window: int = 0           # window for 'attn_local' blocks
    attn_logit_softcap: float = 0.0   # Gemma-2
    final_logit_softcap: float = 0.0  # Gemma-2
    mrope_sections: Tuple[int, ...] = ()   # Qwen2-VL M-RoPE half-dim split

    # ---- MLA (DeepSeek-V2) ----
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- FFN / MoE ----
    ffn_kind: str = "swiglu"          # swiglu | gelu
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0            # DeepSeek-V2: first layer dense
    # §Perf knob: keep the expert f dim sharded over "data" through the
    # expert einsums (partial-sum all-reduce of activations) instead of
    # letting SPMD all-gather the FSDP-sharded expert weights per layer.
    moe_partial_sum: bool = False
    # §Perf knob: cast attention probabilities to bf16 for the p@v einsum
    # (fp32 max/denominator kept) — halves the dominant HBM traffic of the
    # lowered blockwise attention.
    attn_p_bf16: bool = False
    # §Perf knob: Megatron-style sequence parallelism — the residual
    # stream stays S-sharded over "model" through norms/FFN; S is gathered
    # only around the mixer.  Turns per-layer TP all-reduces of full
    # activations into bf16 gather/scatter pairs and keeps backward
    # recompute local.
    seq_parallel: bool = False

    # ---- layer pattern ----
    block_pattern: Tuple[str, ...] = ("attn",)
    # block kinds: attn | attn_local | attn_global | mamba | mlstm | slstm

    # ---- SSM ----
    ssm_state_dim: int = 16           # Mamba N
    ssm_conv_width: int = 4
    ssm_expand: int = 2               # Mamba inner = expand * d_model

    # ---- embeddings / misc ----
    tie_embeddings: bool = False
    scale_embeddings: bool = False    # Gemma-2: x *= sqrt(d_model)
    post_block_norm: bool = False     # Gemma-2: extra norms around blocks
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # modality stub: forward consumes precomputed (B, S, d_model) embeddings
    frontend_stub: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.num_layers % len(self.block_pattern) and \
                self.num_layers > self.first_k_dense:
            n = self.num_layers - self.first_k_dense
            if n % len(self.block_pattern):
                raise ValueError(
                    f"{self.name}: num_layers-first_k_dense ({n}) not a "
                    f"multiple of pattern length {len(self.block_pattern)}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_pattern_repeats(self) -> int:
        return (self.num_layers - self.first_k_dense) \
            // len(self.block_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def layer_kind(self, i: int) -> str:
        """Block kind of global layer index ``i``."""
        if i < self.first_k_dense:
            return self.block_pattern[0] if self.block_pattern else "attn"
        j = (i - self.first_k_dense) % len(self.block_pattern)
        return self.block_pattern[j]

    def layer_uses_moe(self, i: int) -> bool:
        if self.moe is None or i < self.first_k_dense:
            return False
        return (i + 1) % self.moe.every_k_layers == 0

    # ------------------------------------------------------------------
    # analytic parameter / FLOP counts (for MODEL_FLOPS = 6*N*D)
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.attention_kind == "mla":
            qp = (d * self.q_lora_rank
                  + self.q_lora_rank * self.num_heads
                  * (self.qk_nope_dim + self.qk_rope_dim)) \
                if self.q_lora_rank else \
                d * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
            kvp = (d * (self.kv_lora_rank + self.qk_rope_dim)
                   + self.kv_lora_rank * self.num_heads
                   * (self.qk_nope_dim + self.v_head_dim))
            op = self.num_heads * self.v_head_dim * d
            return qp + kvp + op
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        b = (self.num_heads + 2 * self.num_kv_heads) * hd \
            if self.qkv_bias else 0
        return q + kv + o + b

    def _dense_ffn_params(self) -> int:
        mult = 3 if self.ffn_kind == "swiglu" else 2
        return mult * self.d_model * self.d_ff

    def _moe_ffn_params(self, active_only: bool) -> int:
        m = self.moe
        assert m is not None
        mult = 3 if self.ffn_kind == "swiglu" else 2
        per_expert = mult * self.d_model * m.d_ff_expert
        router = self.d_model * m.num_experts
        n_exp = (m.top_k if active_only else m.num_experts)
        total = n_exp * per_expert + router
        total += m.num_shared_experts * per_expert
        if m.dense_residual:
            total += self._dense_ffn_params()
        return total

    def _ssm_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "mamba":
            di = self.ssm_expand * d
            n = self.ssm_state_dim
            return (d * 2 * di            # in_proj (x, z)
                    + di * self.ssm_conv_width
                    + di * (2 * n + 1) + di  # dt/B/C proj + dt bias (approx)
                    + di * n                 # A
                    + di * d)                # out_proj
        if kind in ("mlstm", "slstm"):
            hd = self.resolved_head_dim
            nh = self.num_heads
            qkv = 3 * d * nh * hd
            gates = 2 * d * nh + 2 * nh  # i/f gate projections + biases
            out = nh * hd * d
            up = 2 * d * self.d_ff if self.d_ff else 0  # optional FFN
            return qkv + gates + out + up
        raise ValueError(kind)

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active, for MoE) parameter count, embeddings included."""
        total = self.vocab_size * self.d_model          # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model     # unembed
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            total += 2 * self.d_model                   # norms
            if kind.startswith("attn"):
                total += self._attn_params()
                if self.layer_uses_moe(i):
                    total += self._moe_ffn_params(active_only)
                elif self.d_ff:
                    total += self._dense_ffn_params()
            else:
                total += self._ssm_params(kind)
                if self.layer_uses_moe(i):
                    total += self._moe_ffn_params(active_only)
                elif kind == "mamba" and self.d_ff:
                    total += self._dense_ffn_params()
        return total

    def model_flops(self, tokens: int, decode: bool = False,
                    context_len: int = 0) -> float:
        """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for training;
        2*N_active*D for a forward-only (serving) step."""
        n_active = self.param_count(active_only=True)
        mult = 2.0 if decode else 6.0
        return mult * n_active * tokens

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, num_experts=min(moe.num_experts, 8),
                top_k=min(moe.top_k, 2),
                d_ff_expert=min(moe.d_ff_expert, 128))
        pat = len(self.block_pattern)
        small = dict(
            num_layers=max(pat, 2 * pat if self.num_layers >= 2 * pat
                           else pat) + self.first_k_dense,
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32 if self.head_dim else 0,
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_dim=32 if self.qk_nope_dim else 0,
            qk_rope_dim=16 if self.qk_rope_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            sliding_window=64 if self.sliding_window else 0,
            mrope_sections=(4, 6, 6) if self.mrope_sections else (),
            moe=moe,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
