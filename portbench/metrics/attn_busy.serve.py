"""Device time of the attention kernels (``csrc/attention.cu``,
``attention_bwd.cu``, ``softmax.cu``, ``decoding.cu``) over the traced
window's seconds, in %."""
from portbench import tracing

PATTERN = (r"flash_kernel|flash_bwd_|softmax_\w*kernel|split_kernel|page_scores_kernel"
           r"|page_pv_kernel|recurrence_kernel|merge_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    _, dur = tracing.family(tr, PATTERN)
    if dur.size == 0:
        return None
    return 100.0 * float(dur.sum()) / tr["window_s"]
