"""Prompt tokens of the window's requests over their summed prefill
seconds (each ending in a synchronise)."""


def read(ctx):
    if ctx["kind"] != "lm" or not ctx["requests"]:
        return None
    r = ctx["requests"]
    return (ctx["batch"] * sum(q["prompt_len"] for q in r)
            / sum(q["prefill_s"] for q in r))
