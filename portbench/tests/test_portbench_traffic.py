"""The traffic is the same for the same seed and differs across seeds,
with the same spread of sizes."""
import json

import numpy as np
import torch

from portbench import traffic
from portbench.tests import tiny

RAG = json.loads((tiny.PORTBENCH / "traffic" / "rag-4k.json").read_text())
TRAIN = json.loads((tiny.PORTBENCH / "traffic" / "train-2k.json").read_text())
SEEDS = (0, 7, 2**31 + 5, 3 * 2**32 + 11)


def _stream(seed, n_per_client=4):
    loop = traffic.ClosedLoop(RAG, seed, 50304)
    return [loop.take(c) for _ in range(n_per_client) for c in range(loop.clients)]


def test_same_seed_same_requests():
    for seed in SEEDS:
        assert _stream(seed) == _stream(seed)


def test_seeds_differ():
    a, b = _stream(SEEDS[0]), _stream(SEEDS[2])
    assert [r["prompt"][:8] for r in a] != [r["prompt"][:8] for r in b]
    assert [r["max_new_tokens"] for r in a] != [r["max_new_tokens"] for r in b]


def test_sizes_in_range_and_spread_alike():
    mix = RAG["prompt"]
    lo = mix["template_len"] + mix["passages"] * mix["passage_len"][0] + mix["question_len"][0]
    hi = mix["template_len"] + mix["passages"] * mix["passage_len"][1] + mix["question_len"][1]
    olo, ohi = RAG["output_len"]
    means = []
    for seed in SEEDS:
        reqs = [r for r in _stream(seed, 8) if r["j"] > 0]
        n = np.asarray([len(r["prompt"]) for r in reqs])
        out = np.asarray([r["max_new_tokens"] for r in reqs])
        assert n.min() >= lo and n.max() <= hi and out.min() >= olo and out.max() <= ohi
        assert n.max() + ohi <= RAG["engine"]["max_context"]
        assert all(0 <= t < 50304 for r in reqs[:4] for t in r["prompt"])
        means.append((n.mean(), out.mean()))
    means = np.asarray(means)
    assert np.ptp(means[:, 0]) < 0.03 * (lo + hi) / 2
    assert np.ptp(means[:, 1]) < 0.02 * (olo + ohi) / 2


def test_shared_template_and_documents_asked_again():
    """Every prompt starts with the run's template; popular documents come
    back, each time with a question of its own."""
    t = RAG["prompt"]["template_len"]
    for seed in SEEDS:
        reqs = _stream(seed, 4)
        assert len({tuple(r["prompt"][:t]) for r in reqs}) == 1
        docs = [tuple(r["prompt"][t:t + 64]) for r in reqs]
        # Zipf(1) over 512 documents: the most asked-for holds ~15% of requests
        top = max(docs.count(d) for d in set(docs))
        assert 0.08 * len(reqs) < top < 0.25 * len(reqs)
        assert len(set(docs)) < 0.8 * len(reqs)
        same = [r["prompt"] for r in reqs if tuple(r["prompt"][t:t + 64]) == docs[0]]
        assert len({tuple(p) for p in same}) == len(same)


def test_first_wave_is_residual():
    for seed in SEEDS:
        loop = traffic.ClosedLoop(RAG, seed, 50304)
        first = [loop.take(c)["max_new_tokens"] for c in range(loop.clients)]
        assert min(first) >= 1 and max(first) <= RAG["output_len"][1]
        assert len(set(first)) > loop.clients // 2


def test_train_batches():
    spec = dict(TRAIN, batch=2, seq=16)
    a = traffic.train_batches(spec, SEEDS[2], 50304, 3, torch.device("cpu"))
    b = traffic.train_batches(spec, SEEDS[2], 50304, 3, torch.device("cpu"))
    c = traffic.train_batches(spec, SEEDS[3], 50304, 3, torch.device("cpu"))
    assert a.shape == (3, 2, 17) and torch.equal(a, b) and not torch.equal(a, c)
    rows = a.reshape(-1, 17)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
