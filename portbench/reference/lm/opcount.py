"""The frozen work of a served request: the operations that the
request's tokens need, counted from the configuration's shapes by its
reference module's ``token_flops``.

A request of ``batch`` sequences reads a prompt of ``prompt_len`` tokens
(each token attends over itself and those before it; the logits at the
last one only) and decodes ``gen_len - 1`` tokens more (each with its
logits); the first generated token comes from the prompt's logits.
Logits that the program works out and the request does not need (a
token-by-token prefill's) are not counted.
"""

from __future__ import annotations

from . import module


def request_flops(config: dict, batch: int, prompt_len: int,
                  gen_len: int) -> int:
    """Operations of one request under ``config`` (its ``reference``
    module counts a token)."""
    count = module(config["reference"]).token_flops
    total = sum(count(config, t + 1, t == prompt_len - 1)
                for t in range(prompt_len))
    total += sum(count(config, prompt_len + j + 1, True)
                 for j in range(gen_len - 1))
    return batch * total
