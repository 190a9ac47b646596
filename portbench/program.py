"""What the benchmark takes from the program: its model configuration,
built from the benchmark's configuration file, and a check that the
benchmark's weight layout is the program's.

The configuration file says how it maps onto the port's ``ModelConfig``,
in its ``program`` block: ``arch``, the port's architecture entry to start
from; ``from``, each field taken from a key of the file; ``set``, each
field given its value outright.  A field whose entry holds a
``torch.dtype`` takes the dtype's name.  So a new configuration, of any
family the port runs, is a file and no code.
"""
from __future__ import annotations

import dataclasses

import torch


def model_config(cell, **extra):
    """The port's ``ModelConfig`` for the cell's configuration file, with
    the activation plan beside it and ``extra`` fields on top."""
    from repro_torch import sfu
    from repro_torch.configs import get_config

    c = cell.config
    spec = c["program"]
    base = get_config(spec["arch"])
    over = {field: c[key] for field, key in spec["from"].items()}
    over.update(spec.get("set", {}))
    for field, value in over.items():
        cur = getattr(base, field)
        if isinstance(cur, torch.dtype):
            over[field] = getattr(torch, value)
        elif isinstance(cur, float) and isinstance(value, int):
            over[field] = float(value)
    over["act_plan"] = sfu.load_plan(cell.root / "configs" / c["plan"])
    over.update(extra)
    return dataclasses.replace(base, **over)


def check_layout(mcfg, params: dict) -> None:
    """Raise unless the benchmark's weight tree has the program's leaves
    and shapes."""
    from repro_torch.models import Model
    from repro_torch.models.common import ParamDef

    defs = Model(mcfg, device="meta").param_defs()

    def walk(d, p, path):
        if isinstance(d, ParamDef):
            if tuple(p.shape) != tuple(d.shape):
                raise ValueError(f"{path}: benchmark shape {tuple(p.shape)} != program {d.shape}")
            return
        if isinstance(d, dict):
            if set(d) != set(p):
                raise ValueError(f"{path}: benchmark keys {sorted(p)} != program {sorted(d)}")
            for k in d:
                walk(d[k], p[k], f"{path}/{k}")
            return
        if len(d) != len(p):
            raise ValueError(f"{path}: {len(p)} entries != program {len(d)}")
        for i, (dd, pp) in enumerate(zip(d, p)):
            walk(dd, pp, f"{path}[{i}]")

    walk(defs, params, "params")
