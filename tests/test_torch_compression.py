"""Port parity: int8 error-feedback gradient compression
(``repro_torch.distributed.compression``) on four gloo ranks against the JAX
package's ``compressed_grad_sync`` under ``jax.vmap(..., axis_name="dp")``
on the same stacked gradients (one CPU device).

* The synced mean and the new residual of every leaf equal JAX's within
  one ulp (rank r against JAX's row r).
* The error-feedback bias test of ``tests/test_distributed.py``: constant
  per-rank gradients, 20 steps, the running average of the compressed means
  within 2e-3 of the true mean.
* A sync over one mesh dim's group (the 2x2 mesh's "data" pairs) takes the
  mean within each pair only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.distributed import compression as jcomp
from torch_mesh_utils import run_ranks

WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    rng = np.random.default_rng(0)
    st = {"g_w": rng.standard_normal((WORLD, 8, 16)).astype(np.float32),
          "g_b": (rng.standard_normal((WORLD, 16)) * 1e-3).astype(np.float32),
          "r_w": (rng.standard_normal((WORLD, 8, 16)) * 1e-2).astype(np.float32),
          "r_b": (rng.standard_normal((WORLD, 16)) * 1e-5).astype(np.float32),
          "ef": rng.standard_normal((WORLD, 32)).astype(np.float32)}
    np.savez(tmp / "stacked.npz", **st)
    return st, run_ranks("compression_sync", tmp, tmp / "stacked.npz", world=WORLD,
                         timeout=180)


def _jax_sync(st):
    grads = {"w": jnp.asarray(st["g_w"]), "b": [jnp.asarray(st["g_b"])]}
    res = {"w": jnp.asarray(st["r_w"]), "b": [jnp.asarray(st["r_b"])]}
    mean, new_res = jax.vmap(lambda g, r: jcomp.compressed_grad_sync(g, r, "dp"),
                             axis_name="dp")(grads, res)
    return ({"w": np.asarray(mean["w"]), "b": np.asarray(mean["b"][0])},
            {"w": np.asarray(new_res["w"]), "b": np.asarray(new_res["b"][0])})


def _within_one_ulp(got, want):
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got.astype(np.float64) - want) <= ulp), \
        float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("leaf", ["w", "b"])
@pytest.mark.parametrize("rank", range(WORLD))
def test_mean_equals_jax_within_one_ulp(runs, rank, leaf):
    st, res = runs
    want_mean, _ = _jax_sync(st)
    _within_one_ulp(res[rank]["mean"][leaf], want_mean[leaf][rank])


@pytest.mark.parametrize("leaf", ["w", "b"])
@pytest.mark.parametrize("rank", range(WORLD))
def test_residual_equals_jax_within_one_ulp(runs, rank, leaf):
    st, res = runs
    _, want_res = _jax_sync(st)
    _within_one_ulp(res[rank]["res"][leaf], want_res[leaf][rank])


def test_init_residuals_are_f32_zeros_of_each_leaf(runs):
    _, res = runs
    assert res[0]["zero_res"] == [(16,), (8, 16)]


@pytest.mark.parametrize("rank", range(WORLD))
def test_error_feedback_reduces_bias_over_steps(runs, rank):
    st, res = runs
    err = float(np.max(np.abs(res[rank]["ef_avg"] - st["ef"].mean(0))))
    assert err < 2e-3, err


@pytest.mark.parametrize("rank", range(WORLD))
def test_sync_over_a_mesh_dims_group(runs, rank):
    """Ranks (0, 2) and (1, 3) form the "data" groups of the (2, 2) mesh:
    each rank's mean is its pair's, within one int8 step of the pair's
    true mean."""
    st, res = runs
    pair = [rank % 2, rank % 2 + 2]
    g = st["ef"][pair]
    step = np.abs(g).max() / 127
    assert np.max(np.abs(res[rank]["data_mean"] - g.mean(0))) <= step + 1e-7
