"""Port parity: the gradient of the fused flash attention
(``repro_torch.kernels.fused.fused_flash_attention``, its ``_FlashOp``)
against the JAX package's.

On the CPU the port's backward is ``fused_flash_attention_bwd_plain``, the
plain version of the CUDA backward kernels, at the row max its plain forward
saved; the JAX side is ``jax.grad`` of its ``fused_flash_attention``, whose
blocked Pallas backward runs in interpret mode.  Both are the gradient of
the dense oracle (one PWL softmax over each whole row) at the forward's row
max, not of the forward's 512-key chain.  Inputs are on the JAX suite's
integer grid (``tests/test_fused_backward.py``: dh = 64, span 8, step
0.125), so every score and every sum of products is exact and no segment or
tie decision can flip; the loss is the JAX suite's ``sum(cos(out))``.
Tolerance: 1e-5 of each gradient's max, the JAX suite's bound for this op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.kernels import fused as jfused
from repro.kernels.fused import attention as jattn
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused import attention as tattn

REL = 1e-5
JAX_BLOCKS = dict(block_q=8, block_kv=128)  # the JAX suite's: several blocks per axis


def _igrid(seed, shape, span=8, step=0.125):
    ints = np.random.default_rng(seed).integers(-span, span + 1, size=shape)
    return (ints * step).astype(np.float32)


def _qkv(B=2, S=20, T=None, H=2, Hkv=2, dh=64, seed=10):
    T = S if T is None else T
    return (_igrid(seed, (B, S, H, dh)), _igrid(seed + 1, (B, T, Hkv, dh)),
            _igrid(seed + 2, (B, T, Hkv, dh)))


def _tables(fn="exp", n_bp=32, fmt="f32"):
    return (sfu.get_store().get(fn=fn, n_breakpoints=n_bp, dtype=fmt),
            tsfu.get_store().get(fn=fn, n_breakpoints=n_bp, dtype=fmt))


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=REL * scale, rtol=REL,
                               err_msg=what)


def _jax_grads(qkv, jt, kv_valid_len=None, loss="cos", w=None, **kw):
    vl = None if kv_valid_len is None else jnp.asarray(kv_valid_len, jnp.float32)

    def f(q, k, v):
        out = jfused.fused_flash_attention(q, k, v, table=jt, kv_valid_len=vl, **kw)
        out = out.astype(jnp.float32)
        return jnp.sum(jnp.cos(out)) if loss == "cos" else jnp.sum(out * w)

    grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in qkv))
    return [np.asarray(g, np.float32) for g in grads]


def _port_grads(qkv, tt, kv_valid_len=None, impl_bwd="fused", loss="cos", w=None,
                dtype=torch.float32, **kw):
    kw.pop("block_q", None)
    kw.pop("block_kv", None)
    vl = None if kv_valid_len is None else torch.as_tensor(kv_valid_len)
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in qkv]
    out = tfused.fused_flash_attention(*ts, table=tt, kv_valid_len=vl, impl_bwd=impl_bwd, **kw)
    out = out.to(torch.float32)
    (torch.cos(out).sum() if loss == "cos" else (out * torch.from_numpy(w)).sum()).backward()
    return [t.grad for t in ts]


def _assert_grads_close(got, want):
    for name, g, w in zip("qkv", got, want):
        _close(g.to(torch.float32).numpy(), w, f"d{name}")


# the JAX suite's attention grad-parity cases (tests/test_fused_backward.py)
CASES = {
    "causal": (lambda: _qkv(), {}, dict(causal=True)),
    "window7": (lambda: _qkv(), {}, dict(causal=True, window=7)),
    "ragged": (lambda: _qkv(), {}, dict(causal=False, kv_valid_len=[9, 17])),
    "gqa": (lambda: _qkv(H=4, Hkv=2), {}, dict(causal=True)),
    "odd_shape": (lambda: _qkv(B=1, S=19, T=13), {}, dict(causal=False)),
    "int8_table": (lambda: _qkv(B=1), dict(fmt="int8"), dict(causal=True)),
    "bf16_table": (lambda: _qkv(B=1), dict(fmt="bf16"), dict(causal=True)),
    "8bp_table": (lambda: _qkv(B=1), dict(n_bp=8), dict(causal=True)),
    "exact_exp": (lambda: _qkv(B=1), None, dict(causal=True)),
    "q_offset": (lambda: _qkv(S=12, T=20), {}, dict(causal=True, q_offset=8)),
}


def _case(name):
    make, table_kw, kw = CASES[name]
    jt, tt = (None, None) if table_kw is None else _tables(**table_kw)
    return make(), jt, tt, dict(kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_grads_match_jax(case):
    qkv, jt, tt, kw = _case(case)
    want = _jax_grads(qkv, jt, **JAX_BLOCKS, **kw)
    _assert_grads_close(_port_grads(qkv, tt, **kw), want)


def test_flash_grads_match_jax_at_two_chain_blocks():
    """S = T = 700, N(0, 1) inputs, causal, H = 2, dh = 64, the 32-breakpoint
    exp table, loss sum(out * w): autograd through the forward's 512-key
    chain differs from JAX's gradient here by 2e-2 of dq's max."""
    rng = np.random.default_rng(0)
    qkv = [rng.standard_normal((1, 700, 2, 64)).astype(np.float32) for _ in range(3)]
    w = rng.standard_normal((1, 700, 2, 64)).astype(np.float32)
    jt, tt = _tables()
    want = _jax_grads(qkv, jt, loss="sum_w", w=w, causal=True)
    _assert_grads_close(_port_grads(qkv, tt, loss="sum_w", w=w, causal=True), want)


@pytest.mark.parametrize("case", ["causal", "window7", "ragged", "gqa", "q_offset"])
def test_fused_backward_matches_recompute(case):
    """The plain version of the backward kernels against autograd through
    the dense oracle (``impl_bwd="recompute"``), both the port's."""
    qkv, _, tt, kw = _case(case)
    _assert_grads_close(_port_grads(qkv, tt, **kw),
                        [g.numpy() for g in _port_grads(qkv, tt, impl_bwd="recompute", **kw)])


@pytest.mark.parametrize("case", ["causal", "window7", "ragged", "gqa", "odd_shape", "q_offset"])
def test_backward_plain_matches_the_jax_passes_on_the_same_max(case):
    """``fused_flash_attention_bwd_plain`` against the JAX package's blocked
    passes (``_flash_bwd_4d``, interpret mode), both given the row max of
    JAX's forward."""
    qkv, jt, tt, kw = _case(case)
    q, k, v = (jnp.asarray(a) for a in qkv)
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dout = _igrid(99, (B, S, H, dh))
    vl = kw.pop("kv_valid_len", None)
    jvl = None if vl is None else jnp.asarray(vl, jnp.float32)
    jkw = dict(causal=kw.get("causal", True), window=kw.get("window"),
               q_offset=kw.get("q_offset", 0), **JAX_BLOCKS)
    plan, tables = jfused.plan_and_operands(jt, None)
    _, m = jattn._attn_fwd_impl(q, k, v, jvl, tables, plan, jkw["causal"], jkw["window"],
                                jkw["q_offset"], JAX_BLOCKS["block_q"], JAX_BLOCKS["block_kv"],
                                True, True)
    qf, kf, vf, vlf, G = jattn._fold_operands(q, k, v, jvl)
    gf = jattn._fold_q_heads(jnp.asarray(dout), B, S, Hkv, G, dh)
    dq4, dk4, dv4 = jattn._flash_bwd_4d(qf, kf, vf, vlf, gf, m, tables, plan=plan, g=G,
                                        interpret=True, **jkw)
    want = [np.asarray(jattn._unfold_q_heads(dq4, B, S, Hkv, G, dh)),
            np.asarray(dk4.reshape(B, Hkv, G, T, dh).sum(2).transpose(0, 2, 1, 3)),
            np.asarray(dv4.reshape(B, Hkv, G, T, dh).sum(2).transpose(0, 2, 1, 3))]
    m_port = torch.from_numpy(np.array(m)[:, :S, 0].reshape(B, H, S))
    tplan, ttables = tfused.plan_and_operands(tt)
    got = tattn.fused_flash_attention_bwd_plain(
        *(torch.from_numpy(a) for a in qkv), torch.from_numpy(dout), m_port, tplan, ttables,
        causal=jkw["causal"], window=jkw["window"], q_offset=jkw["q_offset"],
        kv_valid_len=None if vl is None else torch.as_tensor(vl))
    _assert_grads_close(got, want)


def test_saved_row_max_is_the_dense_row_max():
    """The plain forward's final running max, the one residual of the
    backward, is bitwise the max of each whole masked row."""
    _, _, tt, _ = _case("ragged")
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 600, 2, 64)).astype(np.float32))
               for _ in range(3))
    plan, tables = tfused.plan_and_operands(tt)
    vl = torch.tensor([600, 513])
    _, m = tattn.fused_flash_attention_plain(q, k, v, plan, tables, causal=True, window=None,
                                             q_offset=0, kv_valid_len=vl)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.125
    keep = tattn._keep(600, 0, 600, True, None, 0, vl, "cpu")[:, :, 0]
    assert torch.equal(m, torch.where(keep, s, -1e30).amax(dim=-1))


def test_bf16_inputs_give_bf16_gradients():
    qkv, jt, tt, kw = _case("gqa")
    grads = _port_grads(qkv, tt, dtype=torch.bfloat16, **kw)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    want = _jax_grads([a.astype(jnp.bfloat16) for a in qkv], jt, **JAX_BLOCKS, **kw)
    for g, w in zip(grads, want):  # grid inputs are exact in bf16: one bf16 rounding apart
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.float().numpy(), w, atol=1e-2 * scale, rtol=1e-2)


@pytest.mark.parametrize("impl_bwd", ["fused", "recompute"])
def test_a_row_with_no_valid_key_gets_zero_gradients(impl_bwd):
    qkv, jt, tt, _ = _case("ragged")
    kw = dict(causal=False, kv_valid_len=[0, 17])
    grads = _port_grads(qkv, tt, impl_bwd=impl_bwd, **kw)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert not any(bool(g[0].any()) for g in grads)
    _assert_grads_close(grads, _jax_grads(qkv, jt, **JAX_BLOCKS, **kw))
