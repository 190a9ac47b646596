"""The plain references, one module a family of architectures:
``portbench/reference/<family>.py``, named by the ``family`` key of a
configuration file.  A family module gives the yardstick all it needs of
an architecture: the port's weight layout (``layout``), the plain float32
forward over served sequences (``served_logits``), training steps
(``train``), and the model FLOPs of a served request and of a training
token (``request_flops``, ``train_flops_token``).  Neither it nor
``pwl.py`` imports anything of the program."""
from __future__ import annotations

import importlib


def family(cfg: dict):
    """The family module of a configuration."""
    return importlib.import_module(f"{__name__}.{cfg['family']}")
