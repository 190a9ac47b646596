"""Architecture configs.  ``get_config("<arch-id>")`` takes the JAX
package's ids (dashes/dots normalized to underscores); only the configs
ported so far exist here."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = ["repro-100m", "olmoe-1b-7b", "whisper-small"]


def _module(arch_id: str):
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
