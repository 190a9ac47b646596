"""Port parity: the page writes that carry the rotary embedding.

``rope_tables`` + ``apply_rope`` against the port's ``rope`` as it was
written before the split (bitwise) and against the JAX package's ``rope``;
``rope_write_prompt_pages_`` and ``rope_append_kv_`` (their plain versions on
the CPU) against the JAX package's ``rope`` followed by its Pallas writes
(interpret mode), and bitwise against the port's own ``rope`` followed by its
plain writes; the refusals; and a paged model call, which must rotate in the
writes and nowhere else, bitwise the call that rotates with ``rope``.

Inputs come from numpy's generator.  Page tables are fragmented by LIFO
reuse, with a pad page, an inactive slot and an append at a page boundary;
the sentinel page 0, which several writers race on, is left out of every
pool comparison.  Tolerances against JAX: 1e-5 in f32 at the writes'
positions (< 64), one bf16 rounding (2^-7 relative) in bf16, where an f32
difference can flip the final rounding; up to position 4100 see
``test_apply_rope_matches_jax_up_to_position_4100``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.models import layers as jlayers
from repro.serving import append_kv, write_prompt_pages
from repro_torch.configs import get_reduced_config
from repro_torch.models import Model
from repro_torch.models import layers as tlayers
from repro_torch.serving import kv_cache as tkv

THETA = 10000.0
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# (H, Hkv, dh): repro-100m's and olmoe's head dims, with and without GQA
HEADS = [(4, 4, 64), (4, 2, 64), (4, 4, 128), (4, 2, 128)]
CASES = [(h, d) for h in HEADS for d in DTYPES]


def _ids(case):
    (H, Hkv, dh), d = case
    return f"H{H}-Hkv{Hkv}-dh{dh}-{d}"


def _rope_before_split(x, positions, theta):
    """The port's ``rope`` before ``rope_tables`` / ``apply_rope``, op for op."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _assert_bitwise(got, want, sentinel=False):
    if sentinel:  # pools: every page but the sentinel
        got, want = got[:, 1:], want[:, 1:]
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _assert_close_to_jax(got, want, dtype, sentinel=False):
    g = got.to(torch.float32).numpy()
    w = np.asarray(want.astype(jnp.float32))
    if sentinel:
        g, w = g[:, 1:], w[:, 1:]
    if dtype == "f32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=1e-6)


def _fragmented_rows(alloc, n_requests, pages_each):
    rows = [[] for _ in range(n_requests)]
    for _ in range(pages_each):
        for r in rows:
            r.extend(alloc.alloc(1))
    for r in rows[::2]:
        alloc.free(r[::-1])
        r.clear()
    for _ in range(pages_each):
        for r in rows[::2]:
            r.extend(alloc.alloc(1))
    return rows


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the tables


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tables_and_apply_rope_are_rope_bitwise(dh, dtype):
    rng = np.random.default_rng(dh)
    tdt = DTYPES[dtype][0]
    x = torch.from_numpy(_normal(rng, (3, 7, 4, dh))).to(tdt)
    for positions in (torch.from_numpy(rng.integers(0, 4100, (3, 7))),  # serving depths
                      torch.arange(7)[None, :].expand(3, 7),  # a prefill
                      torch.from_numpy(rng.integers(0, 4100, (3,), dtype=np.int32))[:, None]):
        positions = positions.expand(3, 7)
        want = _rope_before_split(x, positions, THETA)
        cos, sin = tlayers.rope_tables(positions, dh, THETA)
        assert cos.shape == sin.shape == (3, 7, dh // 2) and cos.dtype == torch.float32
        _assert_bitwise(tlayers.apply_rope(x, cos, sin), want)
        _assert_bitwise(tlayers.rope(x, positions, THETA), want)


@pytest.mark.parametrize("dh", [64, 128])
def test_apply_rope_matches_jax_up_to_position_4100(dh):
    """Within 1e-5 plus what one ulp of a frequency becomes at the position.

    torch's and XLA's f32 ``exp`` differ in the last bit on a few of the
    frequencies (5 of 32 at dh 64, 9 of 64 at dh 128, never by more than one
    ulp), and the angle multiplies that by the position: at 4100 it is up to
    ~2.4e-4 rad, and the angles' own f32 roundings then differ by up to an
    ulp of the angle.  So element by element |port - JAX| <= 1e-5 +
    2^-22 * pos * (|x1| + |x2|): two ulps (2^-23 relative) of the angle,
    carried by the rotation's two products."""
    rng = np.random.default_rng(7 + dh)
    half = dh // 2
    x = _normal(rng, (2, 9, 3, dh))
    positions = rng.integers(0, 4101, (2, 9))
    positions[0, :5], positions[1, -1] = [0, 1, 17, 40, 63], 4100
    want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(positions), THETA))
    cos, sin = tlayers.rope_tables(torch.from_numpy(positions), dh, THETA)
    got = tlayers.apply_rope(torch.from_numpy(x), cos, sin).numpy()

    # the frequencies (the angles at position 1) within one ulp of JAX's
    one = torch.ones((1, 1), dtype=torch.int64)
    freqs_t = torch.atan2(*tlayers.rope_tables(one, dh, THETA)[::-1])[0, 0].numpy()
    freqs_j = np.asarray(jnp.exp(-math.log(THETA) * jnp.arange(0, half, dtype=jnp.float32)
                                 / half))
    assert np.abs(freqs_t - freqs_j).max() <= 2.0 ** -23
    x12 = np.abs(x[..., :half]) + np.abs(x[..., half:])
    carried = 2.0 ** -22 * positions[..., None, None] * np.concatenate([x12, x12], -1)
    assert (np.abs(got - want) <= 1e-5 + carried).all()
    small = positions < 64  # near the start the frequencies' ulp does not show
    np.testing.assert_allclose(got[small], want[small], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the fused writes' plain versions


def _prompt_case(H, Hkv, dh, seed):
    B, npg, ps, P = 3, 3, 4, 16
    rows = _fragmented_rows(tkv.PageAllocator(P), B, npg)
    table = np.zeros((B, npg + 1), np.int32)  # one spare sentinel column
    for b, r in enumerate(rows):
        table[b, :len(r)] = r
    table[1, 2] = tkv.SENTINEL_PAGE  # a pad page of a shorter prompt
    S = npg * ps
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, (B, S, n, dh)) for n in (H, Hkv, Hkv))
    kp, vp = (_normal(rng, (Hkv, P, ps, dh)) for _ in range(2))
    return {"q": q, "k": k, "v": v, "kp": kp, "vp": vp, "table": table,
            "positions": np.broadcast_to(np.arange(S)[None, :], (B, S))}


def _append_case(H, Hkv, dh, seed):
    B, ps, P = 4, 4, 20
    rows = _fragmented_rows(tkv.PageAllocator(P), 3, 3)
    table = np.zeros((B, 4), np.int32)  # row 3 stays all-sentinel (inactive)
    for b, r in enumerate(rows):
        table[b, :len(r)] = r
    # mid-page, the first slot of a page (a boundary), the last slot, inactive
    kv_len = np.array([ps + 1, ps, 2 * ps - 1, 0], np.int32)
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, (B, 1, n, dh)) for n in (H, Hkv, Hkv))
    kp, vp = (_normal(rng, (Hkv, P, ps, dh)) for _ in range(2))
    return {"q": q, "k": k, "v": v, "kp": kp, "vp": vp, "table": table, "kv_len": kv_len,
            "positions": kv_len[:, None]}


def _torch_case(c, tdt):
    t = {n: torch.from_numpy(np.ascontiguousarray(c[n])).to(tdt)
         for n in ("q", "k", "v", "kp", "vp")}
    t["table"] = torch.from_numpy(c["table"])
    t["positions"] = torch.from_numpy(np.ascontiguousarray(c["positions"]))
    if "kv_len" in c:
        t["kv_len"] = torch.from_numpy(c["kv_len"])
    return t


def _jax_case(c, jdt):
    j = {n: jnp.asarray(c[n]).astype(jdt) for n in ("q", "k", "v", "kp", "vp")}
    jq = jlayers.rope(j["q"], jnp.asarray(c["positions"]), THETA)
    jk = jlayers.rope(j["k"], jnp.asarray(c["positions"]), THETA)
    return j, jq, jk


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_rope_write_prompt_pages_matches_jax_and_rope_then_write(case):
    (H, Hkv, dh), dtype = case
    tdt, jdt = DTYPES[dtype]
    c = _prompt_case(H, Hkv, dh, seed=dh + H + Hkv)
    t = _torch_case(c, tdt)
    cos, sin = tlayers.rope_tables(t["positions"], dh, THETA)
    kp, vp = t["kp"].clone(), t["vp"].clone()
    out = tkv.rope_write_prompt_pages_(t["q"], t["k"], t["v"], kp, vp, t["table"], cos, sin)
    q_rot, k_rot = out
    assert q_rot.shape == t["q"].shape and k_rot.shape == t["k"].shape
    assert q_rot.dtype == k_rot.dtype == tdt
    assert not torch.equal(kp, t["kp"])

    # the port's own rotation, then its plain write: bitwise
    want_q = tlayers.rope(t["q"], t["positions"], THETA)
    want_k = tlayers.rope(t["k"], t["positions"], THETA)
    wkp, wvp = t["kp"].clone(), t["vp"].clone()
    tkv.write_prompt_pages_plain(wkp, wvp, want_k, t["v"], t["table"])
    _assert_bitwise(q_rot, want_q)
    _assert_bitwise(k_rot, want_k)
    _assert_bitwise(kp, wkp, sentinel=True)
    _assert_bitwise(vp, wvp, sentinel=True)

    # the JAX package: rope, then its Pallas prompt write
    j, jq, jk = _jax_case(c, jdt)
    jkp, jvp = write_prompt_pages(j["kp"], j["vp"], jk, j["v"], jnp.asarray(c["table"]))
    _assert_close_to_jax(q_rot, jq, dtype)
    _assert_close_to_jax(k_rot, jk, dtype)
    _assert_close_to_jax(kp, jkp, dtype, sentinel=True)
    _assert_close_to_jax(vp, jvp, dtype, sentinel=True)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_rope_append_kv_matches_jax_and_rope_then_append(case):
    (H, Hkv, dh), dtype = case
    tdt, jdt = DTYPES[dtype]
    c = _append_case(H, Hkv, dh, seed=3 * dh + H + Hkv)
    t = _torch_case(c, tdt)
    cos, sin = tlayers.rope_tables(t["kv_len"][:, None], dh, THETA)
    kp, vp = t["kp"].clone(), t["vp"].clone()
    q_rot = tkv.rope_append_kv_(t["q"], t["k"], t["v"], kp, vp, t["table"], t["kv_len"],
                                cos, sin)
    assert q_rot.shape == t["q"].shape and q_rot.dtype == tdt
    # one row a request changed, the inactive slot's landed in the sentinel
    changed = (kp != t["kp"]).any(dim=3).any(dim=0)
    assert int(changed[1:].sum()) == 3

    want_q = tlayers.rope(t["q"], t["positions"], THETA)
    want_k = tlayers.rope(t["k"], t["positions"], THETA)
    wkp, wvp = t["kp"].clone(), t["vp"].clone()
    tkv.append_kv_plain(wkp, wvp, want_k, t["v"], t["table"], t["kv_len"])
    _assert_bitwise(q_rot, want_q)
    _assert_bitwise(kp, wkp, sentinel=True)
    _assert_bitwise(vp, wvp, sentinel=True)

    j, jq, jk = _jax_case(c, jdt)
    jkp, jvp = append_kv(j["kp"], j["vp"], jk, j["v"], jnp.asarray(c["table"]),
                         jnp.asarray(c["kv_len"]))
    _assert_close_to_jax(q_rot, jq, dtype)
    _assert_close_to_jax(kp, jkp, dtype, sentinel=True)
    _assert_close_to_jax(vp, jvp, dtype, sentinel=True)


def test_strided_projections_are_read_in_place():
    """q, k, v as views of one fused projection (strides the kernel takes as
    arguments) give what their contiguous copies give."""
    rng = np.random.default_rng(11)
    c = _prompt_case(4, 2, 64, seed=11)
    qkv = torch.from_numpy(_normal(rng, (3, 12, 8, 64))).to(torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    t = _torch_case(c, torch.bfloat16)
    cos, sin = tlayers.rope_tables(t["positions"], 64, THETA)
    a = (t["kp"].clone(), t["vp"].clone())
    b = (t["kp"].clone(), t["vp"].clone())
    got = tkv.rope_write_prompt_pages_(q, k, v, *a, t["table"], cos, sin)
    want = tkv.rope_write_prompt_pages_(q.contiguous(), k.contiguous(), v.contiguous(), *b,
                                        t["table"], cos, sin)
    for g, w in zip((*got, *a), (*want, *b)):
        _assert_bitwise(g, w)


# ---------------------------------------------------------------------------
# refusals


def _small(dtype=torch.float32, H=4, Hkv=2, dh=8, S=4, B=1, P=6, ps=4):
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt)  # noqa: E731
    return {"q": z(B, S, H, dh), "k": z(B, S, Hkv, dh), "v": z(B, S, Hkv, dh),
            "kp": z(Hkv, P, ps, dh), "vp": z(Hkv, P, ps, dh),
            "table": torch.tensor([[3, 1]] * B, dtype=torch.int32)[:, :max(1, S // ps)],
            "cos": z(B, S, dh // 2, dt=torch.float32), "sin": z(B, S, dh // 2, dt=torch.float32)}


def _prompt(a):
    return tkv.rope_write_prompt_pages_(a["q"], a["k"], a["v"], a["kp"], a["vp"], a["table"],
                                        a["cos"], a["sin"])


def _append(a, kv_len):
    return tkv.rope_append_kv_(a["q"], a["k"], a["v"], a["kp"], a["vp"], a["table"], kv_len,
                               a["cos"], a["sin"])


@pytest.mark.parametrize("bad, match", [
    ({"q": torch.zeros(1, 4, 4, 6)}, "q must be"),
    ({"q": torch.zeros(1, 3, 4, 8)}, "q must be"),
    ({"cos": torch.zeros(1, 4, 8)}, "cos and sin must be"),
    ({"sin": torch.zeros(1, 4, 3)}, "cos and sin must be"),
    ({"cos": torch.zeros(1, 4, 4, dtype=torch.float64)}, "float32"),
    ({"q": torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)}, "share one of"),
    ({"kp": torch.zeros(2, 6, 4, 8, dtype=torch.bfloat16),
      "vp": torch.zeros(2, 6, 4, 8, dtype=torch.bfloat16)}, "share one of"),
    ({"k": torch.zeros(1, 4, 3, 8), "v": torch.zeros(1, 4, 3, 8)}, "new K/V must be"),
])
def test_rope_writes_refuse_bad_shapes_and_types(bad, match):
    a = {**_small(), **bad}
    with pytest.raises((ValueError, TypeError), match=match):
        _prompt(a)


def test_rope_writes_refuse_odd_head_dims_and_misfit_prompts():
    with pytest.raises(ValueError, match="even head dim"):
        _prompt(_small(dh=7))
    with pytest.raises(ValueError, match="multiple of page_size"):
        _prompt(_small(S=6))
    a = _small(S=8)
    a["table"] = a["table"][:, :1]
    with pytest.raises(ValueError, match="too narrow"):
        _prompt(a)
    with pytest.raises(ValueError, match="one token per request"):
        _append(_small(S=4), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="one token per request"):
        _append(_small(S=1, B=2), torch.zeros(1, dtype=torch.int32))


def test_rope_writes_refuse_other_devices():
    a = {n: t.to("meta") for n, t in _small(S=1).items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        _append(a, torch.zeros(1, dtype=torch.int32, device="meta"))
    a = {n: t.to("meta") for n, t in _small().items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        _prompt(a)


@pytest.mark.parametrize("case", ["past_the_table", "page_out_of_pool", "negative_len",
                                  "prompt_page_out_of_pool"])
def test_rope_writes_outside_the_pools_raise(case):
    ps, P = 4, 6
    if case == "prompt_page_out_of_pool":
        a = _small(S=8)
        a["table"] = torch.tensor([[3, P]], dtype=torch.int32)
        a["k"] = torch.ones_like(a["k"])
        with pytest.raises(ValueError, match="outside"):
            _prompt(a)
    else:
        a = _small(S=1, B=2)
        a["table"] = torch.tensor([[3, 1], [2, 0]], dtype=torch.int32)
        kv_len = torch.tensor([5, 0], dtype=torch.int32)
        if case == "past_the_table":
            kv_len[0] = 2 * ps
        elif case == "page_out_of_pool":
            a["table"][1, 1] = P
        else:
            kv_len[1] = -1
        a["k"] = torch.ones_like(a["k"])
        with pytest.raises(ValueError, match="outside"):
            _append(a, kv_len)
    assert not a["kp"].any() and not a["vp"].any()


def test_vector_width_follows_alignment():
    """16 bytes of elements an item where every row and piece is 16-byte
    aligned, else one element (the kernel's two instantiations)."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    assert tkv._vec(2, 32, [x], [64, 128]) == 8
    assert tkv._vec(4, 32, [x.view(torch.float32)], [32]) == 4
    assert tkv._vec(2, 12, [x], [64]) == 1  # a half row of 12 bf16 is not 16-byte pieces
    assert tkv._vec(2, 32, [x[1:]], [64]) == 1  # a view 2 bytes past alignment
    assert tkv._vec(2, 32, [x], [68]) == 1  # rows 136 bytes apart


# ---------------------------------------------------------------------------
# the paged model calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_kv_heads", [4, 2])
def test_paged_calls_rotate_in_the_writes(monkeypatch, dtype, n_kv_heads):
    """prefill_paged and decode_step_paged rotate through the fused writes,
    once a layer, never through ``rope``; their logits and pools are bitwise
    those of the same calls rotating with ``rope`` before the plain writes."""
    cfg = get_reduced_config("repro-100m", act_impl="fused", dtype=dtype, n_kv_heads=n_kv_heads)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    ps, P, L = 8, 12, cfg.n_layers
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 16)).astype(np.int32))
    table = torch.tensor([[7, 2, 9]], dtype=torch.int32)

    def session(fused: bool):
        cache = model.make_paged_cache(P, ps)
        calls = {"prompt": 0, "append": 0}
        for name, key in (("rope_write_prompt_pages_", "prompt"), ("rope_append_kv_", "append")):
            fn = getattr(tkv, name)

            def counted(*a, _fn=fn, _key=key):
                calls[_key] += 1
                return _fn(*a)

            monkeypatch.setattr(tkv, name, counted)
        if fused:
            def no_rope(*a, **kw):
                raise AssertionError("rope() ran on a paged call")

            monkeypatch.setattr(tlayers, "rope", no_rope)
        else:  # the paged calls without their tables: rope(), then the plain writes
            real = tlayers.attention_layer

            def without_tables(*a, paged=None, **kw):
                if paged is not None:
                    paged = {k: v for k, v in paged.items() if k != "rope"}
                return real(*a, paged=paged, **kw)

            monkeypatch.setattr(tlayers, "attention_layer", without_tables)
        logits = [model.prefill_paged(params, prompt, cache, table[:, :2],
                                      torch.tensor([16], dtype=torch.int32))]
        tok = logits[0].argmax(-1).to(torch.int32)
        for step in range(2):
            kv_len = torch.tensor([16 + step], dtype=torch.int32)
            logits.append(model.decode_step_paged(params, tok, cache, table, kv_len))
            tok = logits[-1].argmax(-1).to(torch.int32)
        monkeypatch.undo()
        return logits, cache, calls

    got, got_cache, calls = session(fused=True)
    assert calls == {"prompt": L, "append": 2 * L}
    want, want_cache, calls = session(fused=False)
    assert calls == {"prompt": 0, "append": 0}
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _assert_bitwise(g, w)
    for g, w in zip(got_cache, want_cache):
        for name in ("k_pages", "v_pages"):
            _assert_bitwise(g[name][:, :, 1:], w[name][:, :, 1:])
