"""Architecture configs.  ``get_config("<arch-id>")`` takes the JAX
package's ids (dashes/dots normalized to underscores); only the configs
ported so far exist here.  Still refused: mamba2-2.7b and jamba-v0.1-52b
(the SSM layers, ``models/ssm.py``), and phi3.5-moe-42b-a6.6b (83.7 GB of
bf16 weights: it waits for distribution)."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = ["repro-100m", "olmoe-1b-7b", "whisper-small", "olmo-1b", "stablelm-1.6b",
            "qwen2.5-32b", "gemma3-1b", "internvl2-1b"]


# the JAX package's other architectures, and what each waits on
REFUSED = {
    "mamba2-2.7b": "the SSM layers (models/ssm.py), not ported yet",
    "jamba-v0.1-52b": "the SSM layers (models/ssm.py) and distribution, not ported yet",
    "phi3.5-moe-42b-a6.6b": "distribution (83.7 GB of bf16 weights), not ported yet",
}


def _module(arch_id: str):
    if arch_id in REFUSED:
        raise ValueError(f"arch {arch_id!r} needs {REFUSED[arch_id]}; ported: {ARCH_IDS}")
    name = arch_id.replace("-", "_").replace(".", "_")
    try:
        return importlib.import_module(f"repro_torch.configs.{name}")
    except ModuleNotFoundError:
        raise ValueError(f"arch {arch_id!r} is not ported yet; ported: {ARCH_IDS}") from None


def get_config(arch_id: str, **overrides):
    cfg = _module(arch_id).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced_config(arch_id: str, **overrides):
    """Small same-family config for CPU tests."""
    cfg = _module(arch_id).reduced()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
