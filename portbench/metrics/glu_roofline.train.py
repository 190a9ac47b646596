"""The GLU kernels' share of their roofline in a training window: the sum
over their launches of each launch's bound (``flops.glu_fwd`` or
``flops.glu_bwd`` at the cell's M = batch·seq, K = d_model, N = d_ff; a
backward launch's name carries ``BackwardEpi``) over their device time, in
%."""
import numpy as np

from portbench import flops, tracing


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    names, dur = tracing.family(tr, r"glu_(tc|pwl)_kernel")
    if dur.size == 0:
        return None
    c, t = ctx["cell"].config, ctx["cell"].traffic
    M, K, N = int(t["batch"]) * int(t["seq"]), c["hidden_size"], c["intermediate_size"]
    bwd = np.asarray(["BackwardEpi" in n for n in names])
    bound = bwd.sum() * flops.glu_bwd(1, M, K, N) + (~bwd).sum() * flops.glu_fwd(1, M, K, N)
    return 100.0 * bound / float(dur.sum())
