"""Tokens the window's decode steps generated (``gen_len - 1`` a
sequence: the first comes from the prefill's logits) over their summed
decode seconds (each ending in a synchronise)."""


def read(ctx):
    if ctx["kind"] != "lm" or not ctx["requests"] or ctx["gen_len"] < 2:
        return None
    r = ctx["requests"]
    return (ctx["batch"] * (ctx["gen_len"] - 1) * len(r)
            / sum(q["decode_s"] for q in r))
