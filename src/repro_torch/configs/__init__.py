"""Architecture configs.  ``get_config("<arch-id>")`` takes the JAX
package's ids (dashes/dots normalized to underscores); only the configs
ported so far exist here.  jamba-v0.1-52b and phi3.5-moe-42b-a6.6b have
their reduced configs (``get_reduced_config``; reduced phi3.5 trains and
serves on a mesh, its experts parallel over "model") but their full widths
are refused: their bf16 weights (102.9 GB, 83.7 GB) pass one card's memory."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = ["repro-100m", "olmoe-1b-7b", "whisper-small", "olmo-1b", "stablelm-1.6b",
            "qwen2.5-32b", "gemma3-1b", "internvl2-1b", "mamba2-2.7b"]


# the JAX package's architectures whose full width waits, and on what
REFUSED = {
    "jamba-v0.1-52b": "two cards for its distribution (102.9 GB of bf16 "
                      "weights), and the chip machine has one; get_reduced_config "
                      "gives its reduced config",
    "phi3.5-moe-42b-a6.6b": "two cards for its distribution (83.7 GB of bf16 "
                            "weights), and the chip machine has one; get_reduced_config "
                            "gives its reduced config",
}
# refused at full width, but with a reduced config here
REDUCED_ONLY = ("jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b")


def _module(arch_id: str, reduced: bool = False):
    if arch_id in REFUSED and not (reduced and arch_id in REDUCED_ONLY):
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
    cfg = _module(arch_id, reduced=True).reduced()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
