"""LM **token** serving: prefill + greedy decode with a KV cache
(the reference's ``repro/launch/token_serve.py``).

This is the transformer-workload scaffolding of the repo (unrelated to
the paper's design-space sweeps): it serves *tokens* from
:mod:`repro_torch.models.transformer`.

    python -m repro_torch.launch.token_serve --arch gemma2-2b
    python -m repro_torch.launch.token_serve --arch qwen2-0.5b \\
        --reduced --device cpu

The prefill runs the prompt through the decode path one token at a time
(cache-exact, as the reference does); then single-token decode steps
with greedy (first maximum) or temperature sampling against the shared
cache.  On the card every norm runs kernel D; decode attention is plain
tensor code.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.sweep import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Batch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prefill(cfg, params, cache, tokens):
    """Sequential prefill via the decode path (cache-exact)."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = T.decode_step(cfg, params, cache,
                                      Batch(tokens=tokens[:, t:t + 1]), t)
    return logits, cache


def next_tokens(logits: torch.Tensor, temperature: float,
                generator: torch.Generator | None) -> torch.Tensor:
    """(B, 1) next tokens from the last position's logits: the first
    maximum when ``temperature`` is 0, else a sample of
    softmax(logits / temperature) drawn from ``generator``."""
    last = logits[:, -1]
    if temperature > 0:
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(last, dim=-1, keepdim=True)


def generate(cfg, params, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None) -> dict:
    """Prefill ``prompts`` (B, P), then decode ``gen`` tokens a sequence
    (the first from the prefill's logits).  Returns the tokens (B, gen)
    and the host seconds of the prefill and of the decode steps, each
    ending in a synchronise."""
    b, plen = prompts.shape
    dev = prompts.device
    cache = T.init_cache(cfg, b, plen + gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, cache, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = next_tokens(logits, temperature, generator)
    generated = [toks]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = T.decode_step(cfg, params, cache, Batch(tokens=toks),
                                      plen + i)
        toks = next_tokens(logits, temperature, generator)
        generated.append(toks)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(generated, dim=1), "prefill_s": t_prefill,
            "decode_s": t_decode}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    if cfg.frontend_stub:
        raise SystemExit(f"{cfg.name} is a modality-stub backbone; "
                         "serve text archs here")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.no_grad():
        params = T.init_params(cfg, gen, dev)
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.batch, args.prompt_len),
                                generator=gen, device=dev)
        run = generate(cfg, params, prompts, args.gen, args.temperature, gen)
    out = run["tokens"].cpu().numpy()
    tput = args.batch * (args.gen - 1) / max(run["decode_s"], 1e-9)
    print(f"[serve] prefill {args.prompt_len} toks in "
          f"{run['prefill_s']:.2f}s; decoded {args.gen - 1} toks/seq x "
          f"{args.batch} seqs ({tput:.1f} tok/s) on {dev}")
    print(f"[serve] sample output ids: {out[0][:12]}")
    return {"tokens": out, "decode_tok_per_s": float(tput),
            "prefill_s": run["prefill_s"],
            "prompts": prompts.cpu().numpy()}


if __name__ == "__main__":
    main()
