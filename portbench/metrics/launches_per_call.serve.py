"""Kernels the device ran in the traced window over the engine's model calls
in it (prefills + decode steps); copies and fills are not counted."""
import numpy as np


def read(ctx):
    tr, c = ctx.get("trace"), ctx.get("counters")
    if tr is None or c is None or not tr["dev_names"]:
        return None
    calls = c["prefills"] + c["decode_steps"]
    if calls <= 0:
        return None
    kern = np.asarray([not n.startswith(("Memcpy", "Memset")) for n in tr["dev_names"]])
    return float(kern[tr["dev_idx"]].sum()) / calls
