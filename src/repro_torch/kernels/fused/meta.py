"""The fused kernels on the meta device: shapes, dtypes and FLOPs, no launch.

A wrapper handed meta operands (the dry run, ``launch/dryrun.py``, traces
a step on meta tensors) calls the custom op here instead of its kernel:
each op's fake implementation returns empty meta outputs of the kernel's
shapes and dtypes, builds nothing and launches nothing, and its FLOP
formula (``torch.utils.flop_counter.register_flop_formula``) counts the
products the kernel does, so a count over a fused plan's step keeps them.
The branch is taken for ``device.type == "meta"`` only (:func:`is_meta`):
on a CPU tensor a wrapper runs its plain version and on a CUDA tensor its
kernel, as before, and these ops refuse any real tensor.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula


def is_meta(t) -> bool:
    """True for a tensor on the meta device: the one test of the wrappers'
    shapes-only branch."""
    return t.device.type == "meta"


def _refuse(*_args, **_kw):
    raise RuntimeError("repro_torch's meta ops take meta tensors only: a CPU tensor runs "
                       "the plain version, a CUDA tensor the kernel")


def attention_pairs(S: int, T: int, causal: bool, window: Optional[int], q_offset: int) -> int:
    """The (query, key) pairs a masked attention computes: query s at
    position ``q_offset + s`` attends keys at most its position when
    ``causal``, within ``window`` of it when given, all T otherwise."""
    p = q_offset + np.arange(S, dtype=np.int64)
    hi = np.minimum(p, T - 1) if causal else np.full(S, T - 1, dtype=np.int64)
    lo = np.maximum(p - window + 1, 0) if window is not None else np.zeros(S, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


# ---------------------------------------------------------------------------
# the GLU family (dense and per expert), the fused linear layer


@torch.library.custom_op("repro_torch::glu", mutates_args=())
def glu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    _refuse()


@glu.register_fake
def _(x, w_gate, w_up):
    return x.new_empty((*x.shape[:-1], w_gate.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.glu)
def _(x_shape, wg_shape, wu_shape, out_shape=None, **kw):
    return 2 * 2 * int(np.prod(x_shape)) * wg_shape[-1]  # both products


@torch.library.custom_op("repro_torch::glu_bwd", mutates_args=())
def glu_bwd(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _refuse()


@glu_bwd.register_fake
def _(x, w_gate, w_up, g):
    return (g.new_empty(g.shape, dtype=torch.float32),
            g.new_empty(g.shape, dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.glu_bwd)
def _(x_shape, wg_shape, wu_shape, g_shape, out_shape=None, **kw):
    return 2 * 2 * int(np.prod(x_shape)) * wg_shape[-1]  # both products, recomputed


@torch.library.custom_op("repro_torch::linear", mutates_args=())
def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _refuse()


@linear.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.linear)
def _(x_shape, w_shape, out_shape=None, **kw):
    return 2 * int(np.prod(x_shape)) * w_shape[-1]


@torch.library.custom_op("repro_torch::linear_bwd", mutates_args=())
def linear_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    _refuse()


@linear_bwd.register_fake
def _(x, w, g):
    return g.new_empty(g.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.linear_bwd)
def _(x_shape, w_shape, g_shape, out_shape=None, **kw):
    return 2 * int(np.prod(x_shape)) * w_shape[-1]  # the product, recomputed


# ---------------------------------------------------------------------------
# attention: the row softmax, the flash attention, the paged decode


@torch.library.custom_op("repro_torch::row_softmax", mutates_args=())
def row_softmax(x: torch.Tensor) -> torch.Tensor:
    _refuse()


@row_softmax.register_fake
def _(x):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::row_softmax_bwd", mutates_args=())
def row_softmax_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    _refuse()


@row_softmax_bwd.register_fake
def _(x, g):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::flash", mutates_args=())
def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          window: Optional[int], q_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    _refuse()


@flash.register_fake
def _(q, k, v, causal, window, q_offset):
    B, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, S), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash)
def _(q_shape, k_shape, v_shape, causal, window, q_offset, out_shape=None, **kw):
    B, S, H, dh = q_shape
    # q k^T and p v over the pairs the masks keep
    return 2 * 2 * B * H * dh * attention_pairs(S, k_shape[1], causal, window, q_offset)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
              causal: bool, window: Optional[int],
              q_offset: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _refuse()


@flash_bwd.register_fake
def _(q, k, v, dout, causal, window, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _(q_shape, k_shape, v_shape, dout_shape, causal, window, q_offset, out_shape=None, **kw):
    B, S, H, dh = q_shape
    # the gradient's five products: q k^T, dout v^T, p^T dout, ds k, ds^T q
    return 5 * 2 * B * H * dh * attention_pairs(S, k_shape[1], causal, window, q_offset)


@torch.library.custom_op("repro_torch::paged_decode", mutates_args=())
def paged_decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
    _refuse()


@paged_decode.register_fake
def _(q, k_pages, v_pages, page_table):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.paged_decode)
def _(q_shape, kp_shape, vp_shape, pt_shape, out_shape=None, **kw):
    B, _, H, dh = q_shape
    # every key the page table can hold: the valid lengths are data
    return 2 * 2 * B * H * dh * pt_shape[1] * kp_shape[2]


# ---------------------------------------------------------------------------
# the fused RMSNorm, the standalone PWL activation (no products)


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    _refuse()


@rmsnorm.register_fake
def _(x, scale):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::rmsnorm_bwd", mutates_args=())
def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor,
                g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _refuse()


@rmsnorm_bwd.register_fake
def _(x, scale, g):
    return (x.new_empty(x.shape, dtype=torch.float32),
            scale.new_empty(scale.shape, dtype=torch.float32))


@torch.library.custom_op("repro_torch::pwl", mutates_args=())
def pwl(x: torch.Tensor) -> torch.Tensor:
    _refuse()


@pwl.register_fake
def _(x):
    return torch.empty_like(x)
