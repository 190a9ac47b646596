"""Exact activation functions + asymptote metadata, in torch.

Counterpart of ``repro/core/functions.py``: each entry names the exact
function a PWL table approximates, its asymptotes (the paper's Sec. IV
boundary condition) and the interpolation range the tables were fitted on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x * _INV_SQRT2))


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x**3)))


def _silu(x):
    return x / (1.0 + torch.exp(-x))


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _tanh(x):
    return torch.tanh(x)


def _exp(x):
    return torch.exp(x)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _elu(x):
    return torch.where(x > 0, x, torch.expm1(x))


def _mish(x):
    return x * torch.tanh(_softplus(x))


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    name: str
    fn: Callable
    # asymptote: f(x) ~ m*x + c for x -> -inf / +inf
    m_left: float
    c_left: float
    m_right: float
    c_right: float
    default_range: tuple[float, float]
    right_is_edge: bool = False  # right boundary pinned to tangent at range edge
    left_is_edge: bool = False

    def asymptote_left(self, p0):
        return self.m_left * p0 + self.c_left

    def asymptote_right(self, pn):
        return self.m_right * pn + self.c_right


REGISTRY: dict[str, FunctionSpec] = {}


def _register(spec: FunctionSpec) -> FunctionSpec:
    REGISTRY[spec.name] = spec
    return spec


GELU = _register(FunctionSpec("gelu", _gelu, 0.0, 0.0, 1.0, 0.0, (-8.0, 8.0)))
GELU_TANH = _register(
    FunctionSpec("gelu_tanh", _gelu_tanh, 0.0, 0.0, 1.0, 0.0, (-8.0, 8.0))
)
SILU = _register(FunctionSpec("silu", _silu, 0.0, 0.0, 1.0, 0.0, (-8.0, 8.0)))
SIGMOID = _register(FunctionSpec("sigmoid", _sigmoid, 0.0, 0.0, 0.0, 1.0, (-8.0, 8.0)))
TANH = _register(FunctionSpec("tanh", _tanh, 0.0, -1.0, 0.0, 1.0, (-8.0, 8.0)))
# exp on [-10, 0.1]: the softmax use-case; right end is a range edge
EXP = _register(
    FunctionSpec("exp", _exp, 0.0, 0.0, math.e**0.1, 0.0, (-10.0, 0.1), right_is_edge=True)
)
SOFTPLUS = _register(FunctionSpec("softplus", _softplus, 0.0, 0.0, 1.0, 0.0, (-8.0, 8.0)))
HARDSWISH = _register(FunctionSpec("hardswish", _hardswish, 0.0, 0.0, 1.0, 0.0, (-8.0, 8.0)))
ELU = _register(FunctionSpec("elu", _elu, 0.0, -1.0, 1.0, 0.0, (-8.0, 8.0)))
MISH = _register(FunctionSpec("mish", _mish, 0.0, 0.0, 1.0, 0.0, (-8.0, 8.0)))


def get(name: str) -> FunctionSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown activation '{name}'; known: {sorted(REGISTRY)}") from None
