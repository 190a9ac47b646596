"""Convert the JAX package's parameter and optimizer trees into the port's.

``params_from_numpy(tree, cfg, device)`` takes the structure the JAX
``model_defs`` (or, for an encoder-decoder, ``encdec_defs``) gives, with
numpy leaves (for example
``jax.tree_util.tree_map(np.asarray, params)``): dicts keyed as in the port,
per-layer leaves stacked ``(n_periods, ...)``.  For serving, matrices go to
``cfg.dtype`` and norm scales and the MoE router stay f32, as :mod:`.common`
holds them, so both packages compute the same thing from the same weights
(the router in bf16 would change which experts are chosen); with
``master=True`` every leaf stays f32, the training masters the JAX package
holds.  ``train_state_from_numpy`` converts a whole JAX AdamW state.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import ModelConfig, ParamDef
from .model import param_defs


def params_from_numpy(tree, cfg: ModelConfig, device, master: bool = False) -> dict:
    dev = torch.device(device)

    def conv(defs, node, path):
        if isinstance(defs, ParamDef):
            a = np.asarray(node)
            if tuple(a.shape) != defs.shape:
                raise ValueError(f"{path}: shape {a.shape} != expected {defs.shape}")
            t = torch.from_numpy(np.array(a, dtype=np.float32))
            dt = cfg.dtype if defs.matrix and not master else torch.float32
            return t.to(device=dev, dtype=dt)
        if isinstance(defs, dict):
            extra = set(node) - set(defs)
            if extra:
                raise ValueError(f"{path}: unexpected keys {sorted(extra)}")
            return {k: conv(v, node[k], f"{path}/{k}") for k, v in defs.items()}
        if len(node) != len(defs):
            raise ValueError(f"{path}: {len(node)} entries != expected {len(defs)}")
        return [conv(d, n, f"{path}[{i}]") for i, (d, n) in enumerate(zip(defs, node))]

    return conv(param_defs(cfg), tree, "params")


def train_state_from_numpy(state, cfg: ModelConfig, device) -> dict:
    """A JAX AdamW state (``{"params", "mu", "nu", "step"}`` with numpy
    leaves) as the port's :mod:`repro_torch.optim.adamw` state: f32 masters
    and moments on ``device``, the step an int64 scalar tensor there."""
    return {
        "params": params_from_numpy(state["params"], cfg, device, master=True),
        "mu": params_from_numpy(state["mu"], cfg, device, master=True),
        "nu": params_from_numpy(state["nu"], cfg, device, master=True),
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int64,
                             device=torch.device(device)),
    }
