"""Port parity: table artifacts, TableStore, eval_coeff, pack_table and the
plan API of ``repro_torch`` against the JAX package ``repro``.

Everything here is bitwise: the same artifact gives the same (bp, m, q) in
every storage format, the same strict compare-count decode gives the same
values (in the table's dtype) on a grid that holds every breakpoint
exactly, and plans share one JSON and one fingerprint.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.configs import get_config
from repro.core import pwl as jpwl
from repro.kernels.fused import epilogue as jepi
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import pwl as tpwl
from repro_torch.kernels.fused import epilogue as tepi

FUNCTIONS = ["gelu", "gelu_tanh", "silu", "sigmoid", "tanh", "exp", "softplus", "hardswish"]
BREAKPOINTS = [8, 16, 32, 64]
FORMATS = ["f32", "bf16", "f16", "int8"]


def _bits(a) -> np.ndarray:
    """Raw bits of a numpy (incl. ml_dtypes bf16) or torch array."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _grid_with_breakpoints(table, lo=-12.0, hi=12.0, n=2001):
    bp = np.asarray(table.bp, np.float32)
    return np.sort(np.concatenate([np.linspace(lo, hi, n, dtype=np.float32), bp]))


def test_artifacts_are_byte_identical_copies():
    src = sorted(sfu.TABLE_DIR.glob("*.npz"))
    dst = sorted(tsfu.TABLE_DIR.glob("*.npz"))
    assert [p.name for p in src] == [p.name for p in dst]
    assert len(src) == 32
    for a, b in zip(src, dst):
        assert hashlib.sha1(a.read_bytes()).digest() == hashlib.sha1(b.read_bytes()).digest(), a.name


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n_bp", BREAKPOINTS)
def test_store_tables_bitwise(fmt, n_bp):
    for fn in FUNCTIONS:
        jt = sfu.get_store().get(fn=fn, n_breakpoints=n_bp, dtype=fmt)
        tt = tsfu.get_store().get(fn=fn, n_breakpoints=n_bp, dtype=fmt)
        assert tt.storage == getattr(jt, "storage", "f32") == fmt
        for f in ("bp", "m", "q"):
            np.testing.assert_array_equal(_bits(getattr(tt, f)), _bits(getattr(jt, f)),
                                          err_msg=f"{fn} {n_bp}bp {fmt} {f}")


@pytest.mark.parametrize("n_bp", BREAKPOINTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_eval_coeff_bitwise_on_breakpoint_grid(n_bp, fmt):
    for fn in FUNCTIONS:
        jt = sfu.get_store().get(fn=fn, n_breakpoints=n_bp, dtype=fmt)
        tt = tsfu.get_store().get(fn=fn, n_breakpoints=n_bp, dtype=fmt)
        x = _grid_with_breakpoints(jt)
        want = np.asarray(jpwl.eval_coeff(jnp.asarray(x), jt))
        got = tpwl.eval_coeff(torch.from_numpy(x), tt).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"{fn} {n_bp}bp {fmt}")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("native", [None, False])
def test_pack_table_bitwise(fmt, native):
    for fn in ("gelu_tanh", "exp", "silu"):
        for n_bp in (16, 64):
            base_j = sfu.get_store().get(fn=fn, n_breakpoints=n_bp)
            base_t = tsfu.get_store().get(fn=fn, n_breakpoints=n_bp)
            jbp, jdmq = jepi.pack_table(base_j, dtype=fmt, native=native)
            tbp, tdmq = tepi.pack_table(base_t, dtype=fmt, native=native)
            assert tuple(tbp.shape) == tuple(jbp.shape) == (n_bp, 1)
            assert tuple(tdmq.shape) == tuple(jdmq.shape) == (n_bp + 1, 2)
            np.testing.assert_array_equal(_bits(tbp), _bits(np.asarray(jbp)))
            np.testing.assert_array_equal(_bits(tdmq), _bits(np.asarray(jdmq)))


def test_plan_json_from_jax_loads_with_same_fingerprint(tmp_path):
    specs = (
        ("mlp:gelu_tanh", sfu.ApproxSpec(fn="gelu_tanh", n_segments=17, dtype="int8",
                                         impl="fused")),
    )
    jcfg = get_config("repro-100m", act_impl="fused", pwl_softmax=True,
                      act_site_specs=specs)
    jplan = sfu.compile_plan(jcfg)
    path = sfu.dump_plan(jplan, tmp_path / "plan.json")
    tplan = tsfu.load_plan(path)
    assert tplan.fingerprint == jplan.fingerprint
    assert [k for k in tplan] == [k for k in jplan]
    for (k, ts), (_, js) in zip(tplan.items(), jplan.items()):
        assert ts.to_json() == js.to_json(), k
    # and back: the port's dump is the JAX package's plan
    back = sfu.load_plan(tsfu.dump_plan(tplan, tmp_path / "back.json"))
    assert back == jplan


def test_compile_plan_of_serve_config_equals_jax():
    jplan = sfu.compile_plan(get_config("repro-100m", act_impl="fused"))
    tplan = tsfu.compile_plan(t_get_config("repro-100m", act_impl="fused"))
    assert tplan.to_json() == jplan.to_json()
    assert tplan.fingerprint == jplan.fingerprint
    assert tsfu.plan_missing_sites(t_get_config("repro-100m"), tplan) == []
    table = tplan.fused_table("mlp:gelu_tanh")
    assert table is not None and table.n_breakpoints == 32


def test_plan_act_resolves_exact_and_pwl():
    x = torch.linspace(-6, 6, 101)
    exact = tsfu.resolve_spec(tsfu.ApproxSpec(fn="gelu_tanh", impl="exact"))
    approx = tsfu.resolve_spec(tsfu.ApproxSpec(fn="gelu_tanh", impl="jnp"))
    assert torch.max(torch.abs(exact(x) - approx(x))) < 5e-3
    # impl="kernel" is the standalone PWL kernel (its plain version on the
    # CPU): the same table by delta accumulation, not by a gather
    kernel = tsfu.resolve_spec(tsfu.ApproxSpec(fn="gelu_tanh", impl="kernel"))
    torch.testing.assert_close(kernel(x), approx(x), rtol=1e-6, atol=1e-6)
