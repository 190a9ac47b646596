"""The flash attention kernels' share of their roofline in a training
window: each forward launch (``flash_kernel``) bounded by ``flops.flash_fwd``
and each backward call (its ``flash_bwd_stats_kernel`` launch; the call's
three kernels share its bound) by ``flops.flash_bwd``, at the cell's batch,
heads, seq and head size, causal; over all their device time, in %."""
import numpy as np

from portbench import flops, tracing


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    names, dur = tracing.family(tr, r"flash_kernel|flash_bwd_")
    if dur.size == 0:
        return None
    c, t = ctx["cell"].config, ctx["cell"].traffic
    B, S, H = int(t["batch"]), int(t["seq"]), c["num_attention_heads"]
    dh = c["hidden_size"] // H
    n_fwd = int(np.sum(["flash_kernel" in n for n in names]))
    n_bwd = int(np.sum(["flash_bwd_stats_kernel" in n for n in names]))
    bound = n_fwd * flops.flash_fwd(B, H, S, S, dh) + n_bwd * flops.flash_bwd(B, H, S, S, dh)
    return 100.0 * bound / float(dur.sum())
