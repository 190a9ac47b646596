"""Unified model API (torch):

    model = Model(cfg, device="cuda")
    params = model.init(seed=0)                     # random weights on device
    masters = model.init(seed=0, master=True)       # f32 training masters
    logits = model.forward(params, tokens)
    loss, metrics = model.loss(masters, {"tokens": ..., "targets": ...})
    logits = model.prefill_paged(params, tokens, cache, page_table, lengths)
    logits = model.decode_step_paged(params, tokens, cache, page_table, kv_len)

The device is explicit and defaults to ``cuda``; pass ``device="cpu"`` to
run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import torch

from . import transformer
from .common import ModelConfig, init_params


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def param_defs(self):
        if self.cfg.is_encoder_decoder:
            raise NotImplementedError("encoder-decoder models are not ported yet")
        return transformer.model_defs(self.cfg)

    def init(self, seed: int = 0, master: bool = False):
        """Random weights: the serving tree, or with ``master=True`` the f32
        training masters (the same values before the cast)."""
        return init_params(self.param_defs(), seed, self.device, self.cfg.dtype,
                           master=master)

    def forward(self, params, tokens):
        return transformer.forward(self.cfg, params, tokens)

    def loss(self, params, batch):
        return transformer.loss_fn(self.cfg, params, batch)

    def make_cache(self, batch: int, max_len: int):
        return transformer.make_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, tokens, cache):
        return transformer.prefill(self.cfg, params, tokens, cache)

    def decode_step(self, params, tokens, cache, pos: int):
        return transformer.decode_step(self.cfg, params, tokens, cache, pos)

    def make_paged_cache(self, num_pages: int, page_size: int):
        return transformer.make_paged_cache(self.cfg, num_pages, page_size, self.device)

    def prefill_paged(self, params, tokens, cache, page_table, lengths):
        return transformer.prefill_paged(self.cfg, params, tokens, cache, page_table,
                                         lengths)

    def decode_step_paged(self, params, tokens, cache, page_table, kv_len):
        return transformer.decode_step_paged(self.cfg, params, tokens, cache,
                                             page_table, kv_len)
