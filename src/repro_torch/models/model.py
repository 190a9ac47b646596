"""Unified model API (torch):

    model = Model(cfg, device="cuda")
    params = model.init(seed=0)                     # random weights on device
    masters = model.init(seed=0, master=True)       # f32 training masters
    logits = model.forward(params, tokens)          # + frames= for an encoder-decoder
    loss, metrics = model.loss(masters, {"tokens": ..., "targets": ...})
    logits = model.prefill(params, tokens, cache)   # + frames= for an encoder-decoder
    logits = model.prefill_paged(params, tokens, cache, page_table, lengths)
    logits = model.decode_step_paged(params, tokens, cache, page_table, kv_len)

Decoder-only configs run ``transformer``; encoder-decoder configs
(whisper) run ``encdec``, whose batches and prefills carry the stub frame
embeddings, and which has the dense cache only (no paged serving, as in the
JAX package).  The device is explicit and defaults to ``cuda``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import torch

from . import encdec, transformer
from .common import ModelConfig, init_params


def param_defs(cfg: ModelConfig):
    """The ParamDef tree of a config's family."""
    if cfg.is_encoder_decoder:
        return encdec.encdec_defs(cfg)
    return transformer.model_defs(cfg)


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._impl = encdec if cfg.is_encoder_decoder else transformer

    def param_defs(self):
        return param_defs(self.cfg)

    def init(self, seed: int = 0, master: bool = False):
        """Random weights: the serving tree, or with ``master=True`` the f32
        training masters (the same values before the cast)."""
        return init_params(self.param_defs(), seed, self.device, self.cfg.dtype,
                           master=master)

    def forward(self, params, tokens, frames=None):
        if self.cfg.is_encoder_decoder:
            return encdec.forward(self.cfg, params, tokens, frames)
        return transformer.forward(self.cfg, params, tokens)

    def loss(self, params, batch):
        return self._impl.loss_fn(self.cfg, params, batch)

    def make_cache(self, batch: int, max_len: int):
        return self._impl.make_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, tokens, cache, frames=None):
        if self.cfg.is_encoder_decoder:
            return encdec.prefill(self.cfg, params, tokens, cache, frames)
        return transformer.prefill(self.cfg, params, tokens, cache)

    def decode_step(self, params, tokens, cache, pos: int):
        return self._impl.decode_step(self.cfg, params, tokens, cache, pos)

    def make_paged_cache(self, num_pages: int, page_size: int):
        if self.cfg.is_encoder_decoder:
            from repro_torch.serving.resilience import UnsupportedCacheError

            raise UnsupportedCacheError("paged serving covers decoder-only models")
        return transformer.make_paged_cache(self.cfg, num_pages, page_size, self.device)

    def prefill_paged(self, params, tokens, cache, page_table, lengths):
        return transformer.prefill_paged(self.cfg, params, tokens, cache, page_table,
                                         lengths)

    def decode_step_paged(self, params, tokens, cache, page_table, kv_len):
        return transformer.decode_step_paged(self.cfg, params, tokens, cache,
                                             page_table, kv_len)
