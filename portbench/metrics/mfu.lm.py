"""The traced requests' frozen bfloat16 work (matrix products and
attention, ``portbench/reference/lm/opcount.py``) over the traced window
at the card's dense bfloat16 peak."""
from portbench.readers import traced


def read(ctx):
    tr = traced(ctx, "lm")
    if tr is None or not ctx["flops"]:
        return None
    return 100.0 * ctx["flops"] / (tr["window_s"]
                                   * ctx["rates"]["bf16_flops_per_s"])
