"""The dense KV cache sharded over its sequence (JAX's ``cache_seq``), on the
CPU with no process group.

* ``Model.cache_specs`` equals JAX's ``rules.tree_specs(logical_specs(
  cache_defs))`` after ``sanitize_spec``, for every arch (full width, and the
  reduced config of the archs refused there) x ``prefill_32k``,
  ``decode_32k``, ``long_500k`` x the (16, 16) and (2, 16, 16) meshes, both
  packages on their ``AbstractMesh``: the sequence over "model" under the
  sequence-parallel rules, over ("data", "model") under the context-parallel
  cell rules (B = 1).
* A rank's cache bytes at full width: qwen2.5-32b ``decode_32k`` on 16 x 16
  holds 4 GiB (64 GiB with the sequence whole), repro-100m 576 MiB (9 GiB),
  jamba-v0.1-52b ``long_500k`` 32 MiB (8 GiB), gemma3-1b ``long_500k``
  8,433,664 B (2059 MiB).
* The per-shard body over n in {2, 4} blocks of the sequence, each block in a
  thread of its own with the all-reduces done between the threads: every
  block ends bitwise the same slice of the single-process cache (a linear
  cache, and a ring written past its wrap), and every decode step is within
  1e-5 of JAX's unfused ``decode_attention`` over the whole cache, under the
  PWL and the exact exp, blocks wholly invalid included, with no NaN.
"""
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

import repro  # noqa: F401
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import Model as JModel
from repro.models import SHAPE_CELLS as JAX_CELLS
from repro.models import layers as jlayers
from repro.models.common import logical_specs as jlogical_specs
from repro_torch.configs import ARCH_IDS, REDUCED_ONLY, get_reduced_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, steps
from repro_torch.models import SHAPE_CELLS, Model
from repro_torch.models import layers

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = ("prefill_32k", "decode_32k", "long_500k")
ARCHS = [(a, False) for a in list(ARCH_IDS) + list(REDUCED_ONLY)] + \
    [(a, True) for a in REDUCED_ONLY]
ARCH_NAMES = [a + ("-reduced" if r else "") for a, r in ARCHS]


def _configs(arch, reduced):
    if reduced:
        return get_reduced_config(arch), jax_reduced(arch)
    return dryrun.dryrun_config(arch), jax_config(arch)


def _leaves(tree):
    """(path, leaf) pairs of a tree of dicts and lists in key order."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", v) for k in sorted(tree) for p, v in _leaves(tree[k])]
    if isinstance(tree, list):
        return [(f"{i}/{p}", v) for i, t in enumerate(tree) for p, v in _leaves(t)]
    return [("", tree)]


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def _cell_caches(arch, reduced, mesh, cell):
    """(rules, port specs, JAX's sanitised specs, (path, shape) pairs) of
    the cell's dense cache."""
    tc, jc = _configs(arch, reduced)
    sizes, axes = MESHES[mesh]
    tm, jm = sh.AbstractMesh(sizes, axes), JAbstractMesh(sizes, axes)
    rules = steps.make_cell_rules(tc, tm, SHAPE_CELLS[cell])
    jrules = jsteps.make_cell_rules(jc, jm, JAX_CELLS[cell])
    B = SHAPE_CELLS[cell].global_batch
    max_len = SHAPE_CELLS[cell].seq_len + (tc.n_vision_tokens or 0)
    jdefs = JModel(jc).cache_defs(B, max_len)
    jspecs = jrules.tree_specs(jlogical_specs(jdefs))
    leaves = [(path, d.shape) for path, d in _leaves(jdefs)]
    shapes = [shape for _, shape in leaves]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = [jsh.sanitize_spec(jm, s, shape)
                for (_, s), shape in zip(_leaves(jspecs), shapes, strict=True)]
    got = Model(tc, device="meta").cache_specs(rules, B, max_len)
    return rules, [s for _, s in _leaves(got)], want, leaves


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch,reduced", ARCHS, ids=ARCH_NAMES)
def test_cache_specs_equal_jaxs(arch, reduced, cell, mesh):
    _, got, want, _ = _cell_caches(arch, reduced, mesh, cell)
    assert [_entries(s) for s in got] == [_entries(s) for s in want]


def _local_bytes(rules, specs, shapes):
    from repro_torch.distributed import shard_fused as shf

    return sum(2 * int(np.prod(shf.local_shape(rules, s, shape)))
               for s, shape in zip(specs, shapes))


@pytest.mark.parametrize("arch,cell,mib,whole_mib", [
    ("qwen2.5-32b", "decode_32k", 4096, 65536),
    ("repro-100m", "decode_32k", 576, 9216),
    ("jamba-v0.1-52b", "long_500k", 32, 8192),
    # 4 global layers of 2048 slots and 22 local rings of 2 slots, of 256 ways
    ("gemma3-1b", "long_500k", 8_433_664 / 2**20, 2059),
])
def test_a_ranks_cache_bytes_on_16x16(arch, cell, mib, whole_mib):
    """bf16 K and V of a rank's attention layers (jamba's SSM states aside);
    with the sequence entry dropped, the layout the port had before."""
    rules, got, _, leaves = _cell_caches(arch, False, "16x16", cell)
    attn = [(s, shape) for s, (path, shape) in zip(got, leaves)
            if path.split("/")[-2] in ("k", "v")]
    specs, shapes = [s for s, _ in attn], [shape for _, shape in attn]
    assert _local_bytes(rules, specs, shapes) == mib * 2**20
    whole = [sh.P(*s[:2], None, *s[3:]) for s in specs]
    assert _local_bytes(rules, whole, shapes) == whole_mib * 2**20


# ---------------------------------------------------------------------------
# the per-shard body over n blocks, one thread each

B, H, HKV, DH = 2, 4, 2, 16


def _in_blocks(n, fn):
    """``fn(i, reduce)`` for i < n, each in a thread; ``reduce(x, op)``
    gathers every thread's ``x`` and returns their max or their sum in block
    order (alike on every block).  Returns the n results."""
    barrier = threading.Barrier(n)
    slots, out, errors = [None] * n, [None] * n, []

    def reducer(i):
        def reduce(x, op):
            slots[i] = x
            barrier.wait()
            xs = list(slots)
            barrier.wait()
            acc = xs[0]
            for y in xs[1:]:
                acc = torch.maximum(acc, y) if op == "max" else acc + y
            return acc
        return reduce

    def run(i):
        try:
            out[i] = fn(i, reducer(i))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _exp_fns(exp):
    kw = dict(pwl_softmax=True, act_impl="jnp") if exp == "pwl" else {}
    tcfg = get_reduced_config("repro-100m", dtype=torch.float32, **kw)
    jcfg = jax_reduced("repro-100m", dtype=jnp.float32, **kw)
    return layers.resolve_exp(tcfg), jlayers.resolve_exp(jcfg)


# (T, window, prefill length, decode steps): a linear cache whose later blocks
# hold no valid slot; a ring prefilled short and decoded past its wrap; a
# ring prefilled past its wrap (S >= T, the roll)
CASES = {"linear": (32, None, 5, 3), "ring": (16, 16, 10, 10), "ring_rolled": (16, 16, 21, 3)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("exp", ["exact", "pwl"])
@pytest.mark.parametrize("n", [2, 4])
def test_block_body_matches_single_process_and_jax(n, exp, case):
    T, window, S, n_steps = CASES[case]
    texp, jexp = _exp_fns(exp)
    rng = np.random.default_rng(11)
    whole = [torch.zeros(B, T, HKV, DH) for _ in range(2)]
    blocks = [[torch.zeros(B, T // n, HKV, DH) for _ in range(2)] for _ in range(n)]
    pos = 0
    for step in range(1 + n_steps):
        s = S if step == 0 else 1
        q, k, v = (torch.from_numpy(rng.standard_normal((B, s, h, DH)).astype(np.float32))
                   for h in (H, HKV, HKV))
        want = layers._dense_cache_attend(q, k, v, *whole, pos, window, texp, None)
        got = _in_blocks(n, lambda i, reduce: layers._dense_cache_attend(
            q, k, v, *blocks[i], pos, window, texp, None, T=T, lo=i * (T // n), reduce=reduce))
        for i in range(n):  # each block bitwise its slice of the single-process cache
            for blk, w in zip(blocks[i], whole):
                assert torch.equal(blk, w[:, i * (T // n):(i + 1) * (T // n)])
        if s == 1:
            assert all(torch.equal(g, got[0]) for g in got)
            assert torch.isfinite(got[0]).all()
            t = np.arange(T)[None, :]
            ring = window is not None
            valid = ((t <= pos) | (pos >= T)) if ring else t <= pos
            ref = jlayers.decode_attention(jnp.asarray(q.numpy()), jnp.asarray(whole[0].numpy()),
                                           jnp.asarray(whole[1].numpy()),
                                           jnp.asarray(np.broadcast_to(valid, (B, T))), jexp)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=1e-5, rtol=0)
            np.testing.assert_allclose(got[0].numpy(), want.numpy(), atol=1e-5, rtol=0)
        pos += s
    if case == "linear":  # the last decode wrote slot 7: every later block held no valid slot
        assert pos - 1 < T // n


def test_block_write_refuses_positions_past_a_linear_cache():
    buf = torch.zeros(1, 4, 1, 2)
    with pytest.raises(ValueError, match="do not fit"):
        layers._write_cache_block(buf, torch.ones(1, 3, 1, 2), 6, 8, 4, ring=False)
