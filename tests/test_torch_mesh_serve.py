"""The sharded engine of the port (``PagedServingEngine(rules=)``) on a
(data=2, model=2) mesh: four gloo ranks on the CPU
(``tests/torch_mesh_workers.py``), f32, held against the port's own
single-process engine (which ``test_torch_engine_parity*.py`` hold against
JAX).

* Paged sessions of reduced repro-100m and olmoe-1b-7b under the fused
  plan with the fused softmax give the single-process session's tokens on
  every rank, with no fused fallback.  Olmoe runs with ``capacity_factor``
  E / K, so no pair is dropped in either session: under the mesh the
  capacity is per data shard (JAX's semantics), which drops other pairs
  than one call over every slot; ``test_torch_mesh_train.py`` holds the
  per-shard drops.
* The pools carry their placements (KV heads over "model"), each rank's
  pool blocks equal the single-process pools' heads (the per-shard page
  writes land in each rank's storage), and the fused calls take plain
  tensors of the local shapes.
* Under the cell rules of a decode cell whose batch (1) the data axis does
  not divide, the cache is sharded over its sequence and the fused decode
  falls back with JAX's warning, once in each of two sessions (JAX's
  ``test_engine_session_warns_once_per_session_on_seq_sharded_cache``),
  the tokens unchanged.
* Dense caches: prefill and decode steps of reduced repro-100m, gemma3-1b
  (rings), mamba2-2.7b (SSM states and conv tails, ``ssm:softplus`` on the
  standalone PWL kernel), jamba-v0.1-52b (SSM, attention and MoE layers)
  and whisper-small (self- and cross-attention K/V) against the
  single-process calls, the fused decode taking plain tensors of a rank's
  batch rows and KV heads.
* Dense caches sharded over their sequence (JAX's ``cache_seq``): reduced
  gemma3-1b under the sequence-parallel rules (its one KV head: the
  sequence over "model", 2 ways) and gemma3-1b and repro-100m under the
  context-parallel rules of a B = 1 decode cell (("data", "model"), 4
  ways), a 12-token prefill and 8 decode steps that wrap the 16-slot rings:
  logits within 1e-4 of single-process torch, the same tokens, each rank's
  block T / extent slots, after every write bitwise the slice that the
  single-process write of the same k / v leaves (the mesh's k / v differ
  from one process's in rounding past the first layer), the fused decode
  falling back once with JAX's warning.
"""
import pytest

from torch_mesh_utils import run_ranks

CASES = {
    "repro-100m": ("repro-100m", '{"act_impl": "fused", "pwl_softmax": true}'),
    "olmoe-1b-7b": ("olmoe-1b-7b",
                    '{"act_impl": "fused", "pwl_softmax": true, "capacity_factor": 4.0}'),
}


@pytest.fixture(scope="module", params=list(CASES))
def session(request, tmp_path_factory):
    arch, over = CASES[request.param]
    return request.param, run_ranks("serve_parity", tmp_path_factory.mktemp("mesh_serve"),
                                    arch, over, timeout=300)


@pytest.fixture(scope="module")
def warned(tmp_path_factory):
    return run_ranks("serve_seq_sharded_warns", tmp_path_factory.mktemp("mesh_warn"),
                     timeout=300)


@pytest.mark.parametrize("rank", range(4))
def test_tokens_equal_the_single_process_session(session, rank):
    _, res = session
    assert res[rank]["tokens"] == res[rank]["ref_tokens"]
    assert len(res[rank]["tokens"]) == 5


def test_no_fused_fallback(session):
    _, res = session
    assert all(r["fallbacks"] == [] for r in res)


@pytest.mark.parametrize("rank", range(4))
def test_pools_placed_and_written_in_each_ranks_storage(session, rank):
    _, res = session
    assert res[rank]["placed"]
    assert res[rank]["local_heads"] == 2  # 4 KV heads over "model"
    assert res[rank]["pool_err"] <= 1e-4


def test_fused_calls_take_plain_local_tensors(session):
    name, res = session
    for r in res:
        names = {c[0] for c in r["calls"]}
        assert {"fused_pwl_softmax", "paged_flash_decode"} <= names
        assert ("fused_moe_glu" if name == "olmoe-1b-7b" else "fused_glu") in names
        for n, plain, shapes in r["calls"]:
            assert plain
            if n == "paged_flash_decode":  # q (4 slots over data, 2 of 4 heads)
                assert shapes[0] == (2, 1, 2, 16) and shapes[1][0] == 2


@pytest.mark.parametrize("i", range(2))
def test_seq_sharded_cache_warns_once_per_session(warned, i):
    for r in warned:
        assert r["table"]["cache_seq"] == ("data", "model")
        tokens, fallbacks = r["sessions"][i]
        assert len(fallbacks) == 1, fallbacks
        assert "sequence axis" in fallbacks[0]
        assert tokens == r["ref_tokens"]


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return run_ranks("dense_cache_parity", tmp_path_factory.mktemp("mesh_dense"), timeout=300)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("arch", ["repro-100m", "gemma3-1b", "mamba2-2.7b", "jamba-v0.1-52b",
                                  "whisper-small"])
def test_dense_cache_prefill_and_decode_match_single_process(dense, arch, rank):
    """A dense cache written and read per shard (gemma3-1b's local layers
    as rings, the SSM layers' states and conv tails, whisper's cross K/V):
    prefill and three decode steps' logits within 1e-4 of the
    single-process calls', whole on every rank, the cache placed by
    ``Model.cache_specs``."""
    r = dense[rank][arch]
    assert r["err"] <= 1e-4 and r["plain"] and r["placed"]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b", "whisper-small"])
def test_ssm_and_encdec_caches_tokens_and_plain_local_calls(dense, arch):
    """The SSM and encoder-decoder sessions on the mesh: the greedy tokens
    of the prefill and every decode step are the single-process ones on
    every rank, no fused call falls back, and every fused call (the
    standalone PWL kernel's among them) takes plain tensors."""
    want = {"mamba2-2.7b": {"pwl_activation"},
            "jamba-v0.1-52b": {"fused_moe_glu", "fused_pwl_softmax"},
            "whisper-small": {"fused_linear", "fused_pwl_softmax"}}[arch]
    for r in dense:
        a = r[arch]
        assert a["tokens"] == a["ref_tokens"]
        assert a["fallbacks"] == []
        assert want <= {c[0] for c in a["calls"]}
        assert all(plain for _, plain, _ in a["calls"])


def test_ssm_cache_local_blocks(dense):
    """Reduced mamba2 (8 heads of 16, d_inner 128, state 16, conv width 4):
    a rank holds half the batch of both leaves, its 4 heads of the state
    and every x|B|C channel of the conv tail; whisper's cross K/V half the
    KV heads."""
    for r in dense:
        conv, ssm = r["mamba2-2.7b"]["local_shapes"]
        assert conv == (2, 2, 3, 160) and ssm == (2, 2, 4, 16, 16)
        k, v, xk, xv = r["whisper-small"]["local_shapes"]
        assert xk == xv == (2, 2, 24, 2, 16) and k == v == (2, 2, 40, 2, 16)


def test_dense_decode_fallback_only_where_the_cache_sequence_is_sharded(dense):
    """repro-100m's heads divide "model": the fused decode runs per shard.
    Reduced gemma3-1b's single KV head does not: sequence-parallel rules,
    the fused decode falls back with JAX's warning, once."""
    for r in dense:
        assert r["repro-100m"]["fallbacks"] == []
        assert len(r["gemma3-1b"]["fallbacks"]) == 1
        assert "decode KV cache is sharded over the sequence axis" in r["gemma3-1b"]["fallbacks"][0]


def test_dense_decode_runs_fused_on_local_tensors(dense):
    """repro-100m's dense decode (4 rows over "data", 4 KV heads over
    "model", a 40-slot cache): the row softmax kernel takes plain tensors
    of a rank's 2 rows and 2 KV heads, once a layer and step."""
    for r in dense:
        calls = r["repro-100m"]["calls"]
        assert all(plain for _, plain, _ in calls)
        decode = [c for c in calls if c[0] == "fused_pwl_softmax" and c[2][0] == (2, 2, 1, 40)]
        assert len(decode) == 3 * 2  # three decode steps, two layers


# sequence-sharded cases of the dense spawn: (cache_seq, extent)
SEQ_CASES = {"gemma3-1b wrap": ("model", 2), "gemma3-1b cp": (("data", "model"), 4),
             "repro-100m cp": (("data", "model"), 4)}


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_seq_sharded_cache_matches_single_process(dense, case, rank):
    r = dense[rank][case]
    seq, extent = SEQ_CASES[case]
    assert r["cache_seq"] == seq
    assert r["err"] <= 1e-4 and r["plain"] and r["placed"]
    assert r["tokens"] == r["ref_tokens"]
    # every layer call of the prefill and the 8 decode steps wrote its block
    # bitwise as the single-process write of the same k / v writes that slice
    n_layers = 6 if case.startswith("gemma") else 2
    assert r["block_writes"] == 9 * n_layers and r["block_mismatches"] == 0
    # gemma3-1b: five 16-slot rings and one 40-slot global layer; repro-100m 40 slots
    want_T = [16] * 10 + [40] * 2 if case.startswith("gemma") else [40, 40]
    assert [s[2] for s in r["local_shapes"]] == [t // extent for t in want_T]


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_seq_sharded_decode_falls_back_once_with_jaxs_words(dense, case):
    for r in dense:
        assert len(r[case]["fallbacks"]) == 1
        assert "decode KV cache is sharded over the sequence axis" in r[case]["fallbacks"][0]
        # the prefill's row softmax runs fused on plain local tensors
        assert any(n == "fused_pwl_softmax" and plain for n, plain, _ in r[case]["calls"])
