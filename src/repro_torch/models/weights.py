"""Convert the JAX package's parameter tree into the port's parameters.

``params_from_numpy(tree, cfg, device)`` takes the structure the JAX
``model_defs`` gives, with numpy leaves (for example
``jax.tree_util.tree_map(np.asarray, params)``): dicts keyed as in the port,
per-layer leaves stacked ``(n_periods, ...)``.  Matrices go to ``cfg.dtype``
and norm scales stay f32, as :mod:`.common` holds them, so both packages
compute the same thing from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import ModelConfig, ParamDef
from .transformer import model_defs


def params_from_numpy(tree, cfg: ModelConfig, device) -> dict:
    dev = torch.device(device)

    def conv(defs, node, path):
        if isinstance(defs, ParamDef):
            a = np.asarray(node)
            if tuple(a.shape) != defs.shape:
                raise ValueError(f"{path}: shape {a.shape} != expected {defs.shape}")
            t = torch.from_numpy(np.array(a, dtype=np.float32))
            return t.to(device=dev, dtype=cfg.dtype if defs.matrix else torch.float32)
        if isinstance(defs, dict):
            extra = set(node) - set(defs)
            if extra:
                raise ValueError(f"{path}: unexpected keys {sorted(extra)}")
            return {k: conv(v, node[k], f"{path}/{k}") for k, v in defs.items()}
        if len(node) != len(defs):
            raise ValueError(f"{path}: {len(node)} entries != expected {len(defs)}")
        return [conv(d, n, f"{path}[{i}]") for i, (d, n) in enumerate(zip(defs, node))]

    return conv(model_defs(cfg), tree, "params")
