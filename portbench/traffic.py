"""The one generator of traffic: it reads a mix's parameters from
``portbench/traffic/<name>.json`` and makes the requests or batches of a
run from ``--seed``.

Sizes and choices are drawn by additive recurrences (``offset + i·alpha``
mod 1, alpha irrational, the offset from the seed), so every seed gives
the same spread of sizes in another order, and any prefix of the sequence
covers the range evenly.  Token ids are uniform over the vocabulary, a
stream of their own for each piece of text.

A prompt is either ``prompt_len`` = [lo, hi] tokens of its own, or, with
a ``prompt`` block, retrieval-augmented: a template shared by every
request of the run (``template_len`` tokens), then a document of the
run's pool of ``documents`` (``passages`` passages, each of
``passage_len`` = [lo, hi] tokens, fixed per document), picked by a Zipf
law of exponent ``zipf_s`` over the pool, so popular documents are asked
about again, then a question of its own (``question_len`` = [lo, hi]).
"""
from __future__ import annotations

import math

import numpy as np
import torch

ALPHA_PROMPT = (math.sqrt(5.0) - 1.0) / 2.0
ALPHA_OUTPUT = math.sqrt(2.0) - 1.0
ALPHA_FIRST = math.sqrt(3.0) - 1.0
ALPHA_PASSAGE = math.sqrt(7.0) - 2.0
ALPHA_QUESTION = math.sqrt(11.0) - 3.0


def _offsets(seed: int) -> np.ndarray:
    return np.random.default_rng([int(seed), 0x7AF1C]).random(5)


def _pick(frac: float, lo: int, hi: int) -> int:
    """An integer of [lo, hi] at ``frac`` of [0, 1)."""
    return lo + min(int(frac * (hi - lo + 1)), hi - lo)


class ClosedLoop:
    """A closed loop of ``clients`` clients: client c's j-th request is
    index i = j·clients + c of the size sequence.  Each client's first
    request (j = 0) has its output length cut to a residual life,
    ``1 + floor(f·L)`` with f spread evenly over the clients, so that the
    first wave ends at staggered steps as a loop in its steady state
    would."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.clients = int(spec["clients"])
        self.off = _offsets(seed)
        self.next_j = [0] * self.clients
        self.rag = spec.get("prompt")
        if self.rag is not None:
            n = int(self.rag["documents"])
            w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** float(self.rag["zipf_s"])
            self.zipf_cdf = np.cumsum(w) / w.sum()
            self.doc_of_rank = np.random.default_rng([self.seed, 0xD0C5]).permutation(n)
            self.template = self._ids([0x7E41], int(self.rag["template_len"]))
            self.docs: dict[int, list[int]] = {}

    def _ids(self, key: list, n: int) -> list[int]:
        rng = np.random.default_rng([self.seed, 0x9E37, *key])
        return rng.integers(0, self.vocab, size=n, dtype=np.int64).tolist()

    def document(self, d: int) -> list[int]:
        """Document d of the pool: its passages' tokens, one after another."""
        if d not in self.docs:
            k = int(self.rag["passages"])
            lo, hi = self.rag["passage_len"]
            n = sum(_pick((self.off[3] + (d * k + p) * ALPHA_PASSAGE) % 1.0, lo, hi)
                    for p in range(k))
            self.docs[d] = self._ids([0xD0C, d], n)
        return self.docs[d]

    def output_len(self, client: int, j: int) -> int:
        i = j * self.clients + client
        lo, hi = self.spec["output_len"]
        out = _pick((self.off[1] + i * ALPHA_OUTPUT) % 1.0, lo, hi)
        if j == 0:
            f = (self.off[2] + client * ALPHA_FIRST) % 1.0
            out = 1 + int(f * out)
        return out

    def prompt(self, client: int, j: int) -> list[int]:
        i = j * self.clients + client
        u = (self.off[0] + i * ALPHA_PROMPT) % 1.0
        if self.rag is None:
            lo, hi = self.spec["prompt_len"]
            return self._ids([client, j], _pick(u, lo, hi))
        rank = min(int(np.searchsorted(self.zipf_cdf, u, side="right")), len(self.zipf_cdf) - 1)
        lo, hi = self.rag["question_len"]
        nq = _pick((self.off[4] + i * ALPHA_QUESTION) % 1.0, lo, hi)
        doc = self.document(int(self.doc_of_rank[rank]))
        return self.template + doc + self._ids([0x9E5, client, j], nq)

    def take(self, client: int) -> dict:
        """The client's next request: id, prompt and output length."""
        j = self.next_j[client]
        self.next_j[client] += 1
        return {"id": f"c{client}-r{j}", "client": client, "j": j,
                "prompt": self.prompt(client, j), "max_new_tokens": self.output_len(client, j)}


def train_batches(spec: dict, seed: int, vocab: int, n: int, device) -> torch.Tensor:
    """``n`` batches of (batch, seq + 1) token ids, int64, drawn on the
    device in one call: batch i feeds step i (tokens ``[:, :-1]``, targets
    ``[:, 1:]``); every row differs."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B1 + 0x5BD1) % (1 << 63))
    return torch.randint(0, int(vocab), (n, int(spec["batch"]), int(spec["seq"]) + 1),
                         generator=gen, device=device, dtype=torch.int64)
