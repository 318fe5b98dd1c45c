"""The program under test on a configuration of kind ``lm``: the port's
language model (``repro_torch.models.transformer``) served through its
normal path, ``repro_torch.launch.token_serve``.  The only module of the
benchmark that imports the port's LM.

The model is ``repro_torch.configs.get_config(<arch>)`` with the
configuration file's ``overrides``: each a key of the port's
``ModelConfig`` with its ``value``, the published value and the key of
the file that it cuts (``file_key``), which ``reduced`` must list.

The weights are the benchmark's inputs, made here from the seed in the
layout of the port's parameter tree (the shapes and types of
``init_params`` on the ``meta`` device, which draws nothing): one flat
buffer a type on the device, filled with standard normals in a few
large draws of a generator on the device, each leaf a view of it scaled
to its fan-in (:func:`leaf_std`).  The plain reference reads the same
tensors.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: Leaves start at a multiple of this many elements (128 bytes in
#: bfloat16), so that every view is aligned as the kernels want it.
ALIGN = 64
#: Elements a draw.
DRAW = 1 << 28
#: The standard deviation of a norm's scale (its weight is 1 + scale)
#: and of any other vector (biases).
NORM_STD = 0.1
VECTOR_STD = 0.02


def import_lm(root: Path):
    """Put the checkout's ``src`` first on the path and import the
    port's LM: (configs, transformer, token_serve)."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch import configs
    from repro_torch.launch import token_serve
    from repro_torch.models import transformer
    return configs, transformer, token_serve


def model_config(configs, config: dict):
    """The port's ``ModelConfig`` of ``config``: its ``arch`` with its
    ``overrides``."""
    vals = {}
    for key, o in config.get("overrides", {}).items():
        if o["file_key"] not in config["reduced"]:
            raise ValueError(f"override {key} cuts {o['file_key']}, which "
                             f"'reduced' does not list")
        vals[key] = o["value"]
    return dataclasses.replace(configs.get_config(config["arch"]), **vals)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, new: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, new, path + (i,))
                          for i, v in enumerate(tree))
    return new[path]


def leaf_std(path: tuple, shape: tuple) -> float:
    """The fan-in scale of a leaf: a norm's scale ``NORM_STD``; another
    vector ``VECTOR_STD``; the embedding table its row width; an output
    projection ``w_o`` (H, Dh, d) its first two dims; an FFN leaf of
    three dims (experts, in, out) its second; any other matrix its
    first (the port's layouts put the input dims first)."""
    name = path[-1]
    if len(shape) == 1:
        return NORM_STD if name == "scale" else VECTOR_STD
    if name == "table":
        fan = shape[-1]
    elif name == "w_o":
        fan = math.prod(shape[:-1])
    elif len(shape) == 3 and "ffn" in path:
        fan = shape[1]
    else:
        fan = shape[0]
    return fan ** -0.5


def weight_seed(seed: int) -> int:
    """The weights' generator seed, apart from the traffic's draws."""
    return int(np.random.SeedSequence([int(seed) % 2**64, 4])
               .generate_state(1, np.uint64)[0] >> 1)


def make_weights(meta_tree, seed: int, device) -> dict:
    """Random weights of ``meta_tree``'s shapes and types on ``device``,
    from the seed (see the module's note)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(weight_seed(seed))
    leaves = list(_leaves(meta_tree))
    offsets, total = {}, {}
    for path, t in leaves:
        at = -(-total.get(t.dtype, 0) // ALIGN) * ALIGN
        offsets[path] = at
        total[t.dtype] = at + t.numel()
    bufs = {}
    for dtype, n in total.items():
        buf = torch.empty(n, dtype=dtype, device=dev)
        for a in range(0, n, DRAW):
            b = min(a + DRAW, n)
            buf[a:b].copy_(torch.randn(b - a, generator=gen, device=dev))
        bufs[dtype] = buf
    new = {}
    for path, t in leaves:
        a = offsets[path]
        new[path] = (bufs[t.dtype][a:a + t.numel()].view(t.shape)
                     .mul_(leaf_std(path, tuple(t.shape))))
    return _rebuild(meta_tree, new)


class Program:
    """The port's LM of ``config``, with the benchmark's weights on
    ``device``, serving requests of at most ``max_len`` positions."""

    def __init__(self, root: Path, config: dict, seed: int, device,
                 max_len: int):
        configs, self.T, self.serve_mod = import_lm(root)
        from repro_torch.kernels.flash_attention import kernel as flash
        from repro_torch.kernels.rmsnorm import kernel as rmsnorm
        self.kernels = {"D": rmsnorm.rmsnorm_fused,
                        "E": flash.flash_attention_fwd}
        self.cfg = model_config(configs, config)
        self.device = torch.device(device)
        self.max_len = max_len
        self.weights = make_weights(
            self.T.init_params(self.cfg, device="meta"), seed, self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, prompts: torch.Tensor, gen: int) -> dict:
        """One request as ``token_serve.generate`` serves it: the prompts
        (B, P) through ``token_serve.prefill``, then ``gen - 1`` greedy
        ``decode_step``s against the cache (the first token from the
        prefill's logits).  Returns the tokens (B, gen), the logits each
        was chosen from (a list of ``gen`` (B, 1, V)), and the host
        seconds of the prefill and of the decode steps, each ending in a
        synchronise."""
        T, serve = self.T, self.serve_mod
        cfg, params = self.cfg, self.weights
        b, plen = prompts.shape
        with torch.no_grad():
            cache = T.init_cache(cfg, b, self.max_len, device=self.device)
            self._sync()
            t0 = time.perf_counter()
            logits, cache = serve.prefill(cfg, params, cache, prompts)
            self._sync()
            prefill_s = time.perf_counter() - t0
            rows = [logits]
            toks = serve.next_tokens(logits, 0.0, None)
            generated = [toks]
            t0 = time.perf_counter()
            for i in range(gen - 1):
                logits, cache = T.decode_step(cfg, params, cache,
                                              T.Batch(tokens=toks), plen + i)
                toks = serve.next_tokens(logits, 0.0, None)
                generated.append(toks)
                rows.append(logits)
            self._sync()
            decode_s = time.perf_counter() - t0
        return {"tokens": torch.cat(generated, dim=1), "logits": rows,
                "prefill_s": prefill_s, "decode_s": decode_s}

    def launches(self) -> dict:
        """Launch counters of kernels D (RMSNorm) and E (flash
        attention)."""
        return {k: f.launches for k, f in self.kernels.items()}
