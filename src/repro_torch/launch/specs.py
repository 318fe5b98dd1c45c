"""Stand-ins for every model input (the reference's
``repro/launch/specs.py``): ``meta``-device tensors, which carry a shape
and a dtype and hold no memory, where the reference builds
``ShapeDtypeStruct`` s.

``input_specs(cfg, shape)`` returns the Batch spec for an (arch x shape)
cell; ``params_specs`` / ``cache_specs`` / ``opt_specs`` give the state
trees.  Modality-stub archs (audio/vlm) get precomputed frame/patch
embeddings instead of token ids, per the assignment.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import compute_dtype
from repro_torch.optim import adamw

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> T.Batch:
    b = shape.global_batch
    s = shape.seq_len if shape.mode != "decode" else 1
    dtype = compute_dtype(cfg)
    tokens = embeds = positions = labels = None
    if cfg.frontend_stub:
        embeds = _sds((b, s, cfg.d_model), dtype)
    else:
        tokens = _sds((b, s), torch.int32)
    if cfg.mrope_sections:
        positions = _sds((3, b, s), torch.int32)
    if shape.mode == "train":
        labels = _sds((b, s), torch.int32)
    return T.Batch(tokens=tokens, embeds=embeds, positions=positions,
                   labels=labels)


def params_specs(cfg: ModelConfig) -> Any:
    """``init_params`` on ``meta``: no generator draws, no memory."""
    return T.init_params(cfg, device=META)


def opt_specs(opt_cfg: adamw.AdamWConfig, params_shapes: Any) -> Any:
    return adamw.init(opt_cfg, params_shapes)


def cache_specs(cfg: ModelConfig, shape: InputShape) -> Any:
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def pos_spec() -> torch.Tensor:
    return _sds((), torch.int32)


def tokens_per_step(cfg: ModelConfig, shape: InputShape) -> int:
    if shape.mode == "decode":
        return shape.global_batch           # one new token per sequence
    return shape.global_batch * shape.seq_len


def moment_dtype_for(cfg: ModelConfig) -> str:
    """bf16 AdamW moments for the 100B+ cells so a single pod holds the
    optimizer (12 B/param fp32 moments would exceed 16 GiB/chip at 480B
    on 256 chips), as the reference chooses."""
    return "bfloat16" if cfg.param_count() > 100e9 else "float32"
