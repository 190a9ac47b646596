"""Device time of the GLU kernels (``csrc/glu.cu``: in an MoE model every
launch is the MoE GLU) over the traced window's seconds, in %."""
from portbench import tracing

PATTERN = r"glu_(tc|pwl)_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    _, dur = tracing.family(tr, PATTERN)
    if dur.size == 0:
        return None
    return 100.0 * float(dur.sum()) / tr["window_s"]
