"""Unified model API (torch):

    model = Model(cfg, device="cuda")
    params = model.init(seed=0)                     # random weights on device
    logits = model.forward(params, tokens)
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

    def init(self, seed: int = 0):
        return init_params(self.param_defs(), seed, self.device, self.cfg.dtype)

    def forward(self, params, tokens):
        return transformer.forward(self.cfg, params, tokens)

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
