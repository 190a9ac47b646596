"""Model FLOPs of the requests finished in the window (the family's
``request_flops``; for a transformer 2·N_active a token, causal attention
of the prefill, each decode over its context) over the window's seconds
and the H100's bf16 peak, in %."""
from portbench import flops


def read(ctx):
    if "flops" not in ctx or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / flops.PEAK_BF16_FLOPS
