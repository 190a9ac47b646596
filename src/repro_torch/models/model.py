"""Unified model API (torch):

    model = Model(cfg, device="cuda")
    params = model.init(seed=0)                     # random weights on device
    masters = model.init(seed=0, master=True)       # f32 training masters
    logits = model.forward(params, tokens)          # + frames= for an encoder-decoder,
                                                    #   vision_embeds= for a VLM prefix
    loss, metrics = model.loss(masters, {"tokens": ..., "targets": ...})
    logits = model.prefill(params, tokens, cache)   # + frames= / vision_embeds= as above
    logits = model.prefill_paged(params, tokens, cache, page_table, lengths)
    logits = model.decode_step_paged(params, tokens, cache, page_table, kv_len)

Decoder-only configs run ``transformer``; encoder-decoder configs
(whisper) run ``encdec``, whose batches and prefills carry the stub frame
embeddings, and which has the dense cache only (no paged serving, as in the
JAX package).  A VLM (internvl2) takes its stub patch embeddings as
``vision_embeds`` (B, n_vision_tokens, d_model), a prefix in front of the
tokens, through ``forward``, ``loss`` (the batch's ``vision_embeds``) and
the dense ``prefill``; paged serving is tokens only, as in the JAX
package.  The device is explicit and defaults to ``cuda``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import dataclasses

import torch

from . import encdec, transformer
from .common import ModelConfig, init_params, logical_specs


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (sequence length, global batch, step kind) point that the
    roofline model (``repro_torch.roofline``) is evaluated at."""

    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


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

    def param_logical(self):
        """The logical-axis tuple of every parameter (the sharding rules'
        input, ``distributed.sharding.specs_for_params``)."""
        return logical_specs(self.param_defs())

    def init(self, seed: int = 0, master: bool = False):
        """Random weights: the serving tree, or with ``master=True`` the f32
        training masters (the same values before the cast)."""
        return init_params(self.param_defs(), seed, self.device, self.cfg.dtype,
                           master=master)

    def forward(self, params, tokens, frames=None, vision_embeds=None):
        if self.cfg.is_encoder_decoder:
            return encdec.forward(self.cfg, params, tokens, frames)
        return transformer.forward(self.cfg, params, tokens, vision_embeds)

    def loss(self, params, batch):
        return self._impl.loss_fn(self.cfg, params, batch)

    def cache_defs(self, batch: int, max_len: int):
        """The dense cache's ParamDef tree, with the JAX package's logical
        axes."""
        return self._impl.cache_defs(self.cfg, batch, max_len)

    def cache_specs(self, rules, batch: int, max_len: int):
        """The spec of each leaf of :meth:`cache_defs` under a mesh (where
        :meth:`make_cache` places it): JAX's logical specs under ``rules``,
        each entry that does not divide its dim replicated."""
        return self._impl.cache_specs(rules, self.cfg, batch, max_len)

    def make_cache(self, batch: int, max_len: int):
        """The dense cache, zeros; under active rules with a mesh, every
        leaf placed by :meth:`cache_specs`."""
        return self._impl.make_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, tokens, cache, frames=None, vision_embeds=None):
        if self.cfg.is_encoder_decoder:
            return encdec.prefill(self.cfg, params, tokens, cache, frames)
        return transformer.prefill(self.cfg, params, tokens, cache, vision_embeds)

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


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Meta tensors standing for one (arch x shape) cell's inputs, with the
    JAX package's keys, shapes and dtypes: ``tokens`` (and ``targets`` to
    train) (B, S) int32, an encoder-decoder's ``frames`` (B, encoder_seq,
    D) and a VLM's ``vision_embeds`` (B, n_vision_tokens, D) in
    ``cfg.dtype``; a decode cell's one new token (B, 1) and its scalar
    ``pos``."""
    B, S = cell.global_batch, cell.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind == "decode":
        return {"tokens": meta((B, 1), torch.int32), "pos": meta((), torch.int32)}
    out = {"tokens": meta((B, S), torch.int32)}
    if cell.kind == "train":
        out["targets"] = meta((B, S), torch.int32)
    if cfg.is_encoder_decoder:
        out["frames"] = meta((B, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    if cfg.n_vision_tokens:
        out["vision_embeds"] = meta((B, cfg.n_vision_tokens, cfg.d_model), cfg.dtype)
    return out
