"""A PWL table as the reference reads it, and its evaluation by the
paper's compare-count decode: ``idx = #{i : x > bp_i}`` and
``y = m[idx]·x + q[idx]`` (``searchsorted`` gives that count for
ascending breakpoints).  The tables are frozen copies of the shipped ones,
handed to both sides."""
from __future__ import annotations

import numpy as np
import torch


def load_table(path) -> dict:
    with np.load(path) as d:
        bp, m, q = (np.asarray(d[k], np.float32) for k in ("bp", "m", "q"))
    if not np.all(np.diff(bp) > 0):
        raise ValueError(f"{path}: breakpoints do not ascend")
    return {"bp": torch.from_numpy(bp), "m": torch.from_numpy(m), "q": torch.from_numpy(q)}


def pwl(x: torch.Tensor, table: dict) -> torch.Tensor:
    bp, m, q = (table[k].to(x.device) for k in ("bp", "m", "q"))
    idx = torch.searchsorted(bp, x.detach().contiguous())
    return m[idx] * x + q[idx]
