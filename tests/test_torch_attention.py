"""Port parity: the fused flash-attention forward with the PWL-exp online
softmax (``repro_torch.kernels.fused.fused_flash_attention``) against the
JAX package's Pallas kernel.

On the CPU the wrapper takes its plain version (the kernel's chain of
512-key blocks); the JAX side runs its Pallas kernel in interpret mode.
S = T = 700 gives two KV blocks, the second ragged.  Tolerance 1e-5 abs/rel
in f32 (the JAX suite's bound for this kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.kernels import fused as jfused
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused.attention import block_kv

TOL = dict(atol=1e-5, rtol=1e-5)


def _tables(n_bp=32, fmt="f32"):
    return (sfu.get_store().get(fn="exp", n_breakpoints=n_bp, dtype=fmt),
            tsfu.get_store().get(fn="exp", n_breakpoints=n_bp, dtype=fmt))


def _qkv(seed, B, S, T, H, Hkv, dh=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, dh)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, dh)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, dh)).astype(np.float32))


def _both(qkv, jt, tt, kv_valid_len=None, **kw):
    jvl = None if kv_valid_len is None else jnp.asarray(kv_valid_len)
    tvl = None if kv_valid_len is None else torch.from_numpy(kv_valid_len)
    want = np.asarray(jfused.fused_flash_attention(*(jnp.asarray(a) for a in qkv), table=jt,
                                                   kv_valid_len=jvl, **kw))
    got = tfused.fused_flash_attention(*(torch.from_numpy(a) for a in qkv), table=tt,
                                       kv_valid_len=tvl, **kw)
    return got, want


CASES = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=128),
    "q_offset": dict(causal=True, q_offset=5),
    "noncausal": dict(causal=False),
}


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_plain_matches_jax_kernel(case, G):
    jt, tt = _tables()
    got, want = _both(_qkv(G, 1, 700, 700, 2 * G, 2), jt, tt, **CASES[case])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_ragged_valid_len_with_an_empty_row():
    """A decode row over a ragged cache, and a batch row with no valid key."""
    jt, tt = _tables()
    vl = np.asarray([650, 0, 513], np.int32)
    got, want = _both(_qkv(3, 3, 1, 700, 4, 2), jt, tt, causal=False, kv_valid_len=vl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[1].any()


@pytest.mark.parametrize("fmt", ["f32", "int8"])
@pytest.mark.parametrize("n_bp", [16, 64])
def test_flash_table_formats_short_cache(n_bp, fmt):
    """T = 300 takes one 384-key block (round_up(T, 128))."""
    jt, tt = _tables(n_bp, fmt)
    assert block_kv(300) == 384 and block_kv(700) == 512
    got, want = _both(_qkv(n_bp, 2, 40, 300, 2, 1), jt, tt, causal=True, q_offset=260)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_exact_exp():
    got, want = _both(_qkv(5, 1, 600, 600, 2, 2), None, None, causal=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
