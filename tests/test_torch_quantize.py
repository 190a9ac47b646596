"""Port parity: the fixed-point datapath (``core/quantize.py``) and the last
public helpers (``pwl.table_to_numpy``, ``serving.make_page_pool``,
``layers.pwl_exp_fn``) of ``repro_torch`` against the JAX package.

Everything is bitwise on the same numpy inputs.  At 32 bits the JAX
function does not run on JAX 0.9.0 or later (it enters
``jax.experimental.enable_x64``, which 0.9.0 removed), so the port is held
against ``_fixed_point_np``, an int64 / float64 numpy rendering of
``src/repro/core/quantize.py:120-126``, which is itself held against JAX's
function at 8 and 16 bits.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.core import pwl as jpwl
from repro.core import quantize as jq
from repro.models import layers as jlayers
from repro.serving import make_page_pool as j_make_page_pool
from repro_torch.core import pwl as tpwl
from repro_torch.core import quantize as tq
from repro_torch.models import layers as tlayers
from repro_torch.serving import make_page_pool

FUNCTIONS = ["gelu", "gelu_tanh", "silu", "sigmoid", "tanh", "exp", "softplus", "hardswish"]
BREAKPOINTS = [8, 16, 32, 64]
TABLES = [(fn, n) for fn in FUNCTIONS for n in BREAKPOINTS]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
X_RANGE = (-8.0, 8.0)


def _tables(fn, n_bp):
    return (tsfu.get_store().get(fn=fn, n_breakpoints=n_bp),
            sfu.get_store().get(fn=fn, n_breakpoints=n_bp))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


def _inputs(qt, dtype) -> torch.Tensor:
    """TestQuantize's grid (4097 points on [-8, 8]), exact ties at half an
    input step, every quantized breakpoint de-quantized with its
    neighbouring steps, and saturating inputs past the range, cast to
    ``dtype`` (the same values then go to both packages)."""
    s = qt.s_x
    k = np.arange(-300, 301, dtype=np.float64)
    bp = qt.bp_q.astype(np.float64)
    sat = np.array([8.5, 9.0, 15.9, 16.0, 20.0, 1e3, 3e4, 1e30], np.float64)
    x = np.concatenate([np.linspace(-8, 8, 4097), (k + 0.5) * s,
                        (bp[:, None] + np.array([-1.0, -0.5, 0.0, 0.5, 1.0])).ravel() * s,
                        sat, -sat, [0.0, -0.0]])
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _jax_eval(x: torch.Tensor, jqt, jdtype) -> np.ndarray:
    y = jq.eval_fixed_point(jnp.asarray(x.float().numpy()).astype(jdtype), jqt)
    assert y.dtype == jdtype
    return np.asarray(y.astype(jnp.float32))


def _fixed_point_np(x: torch.Tensor, qt) -> torch.Tensor:
    """``src/repro/core/quantize.py:120-126`` in numpy: x in float64, the
    compare-count decode and the MADD in int64, the result float64 x scale,
    then f32, then x's dtype."""
    lo, hi = jq._INT_INFO[qt.bits]
    xq = np.clip(np.round(x.double().numpy() / qt.s_x), lo, hi).astype(np.int64)
    idx = np.sum(xq[..., None] > np.asarray(qt.bp_q), axis=-1)
    acc = np.asarray(qt.m_q)[idx] * xq + np.asarray(qt.q_q)[idx]
    y = acc.astype(np.float64) * (qt.s_m * qt.s_x)
    return torch.from_numpy(y.astype(np.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# quantize_table


@pytest.mark.parametrize("x_range", [(-8.0, 8.0), (-4.0, 4.0)])
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("fn,n_bp", TABLES)
def test_quantize_table_bitwise(fn, n_bp, bits, x_range):
    tt, jt = _tables(fn, n_bp)
    got, want = tq.quantize_table(tt, bits, x_range), jq.quantize_table(jt, bits, x_range)
    for f in ("bp_q", "m_q", "q_q"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.int64, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.s_x, got.s_m, got.bits, got.name) == (want.s_x, want.s_m, want.bits, want.name)


def test_quantize_table_refuses_other_widths():
    tt, jt = _tables("gelu", 32)
    with pytest.raises(ValueError, match="bits must be one of") as want:
        jq.quantize_table(jt, 12, X_RANGE)
    with pytest.raises(ValueError, match="bits must be one of") as got:
        tq.quantize_table(tt, 12, X_RANGE)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# eval_fixed_point


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("fn,n_bp", TABLES)
def test_eval_fixed_point_bitwise_jax(fn, n_bp, bits, dtype):
    """8/16 bits: x rounded and clipped in its own dtype (a saturating
    16-bit bf16 or f16 input decodes at 32768, f32 at 32767), the int32
    MADD, the result in x's dtype, bitwise JAX's."""
    tdt, jdt = DTYPES[dtype]
    tt, jt = _tables(fn, n_bp)
    qt, jqt = tq.quantize_table(tt, bits, X_RANGE), jq.quantize_table(jt, bits, X_RANGE)
    x = _inputs(qt, tdt)
    y = tq.eval_fixed_point(x, qt)
    assert y.dtype == tdt and y.shape == x.shape
    np.testing.assert_array_equal(_bits(y.float()), _bits(torch.from_numpy(
        _jax_eval(x, jqt, jdt))))


def _line(m: float, q: float):
    """y = m x + q, one breakpoint at 0, in both packages (f32 arrays)."""
    arrs = [np.array([0.0], np.float32), np.full(2, m, np.float32), np.full(2, q, np.float32)]
    return (tpwl.PWLTable(*(torch.from_numpy(a) for a in arrs), name="line"),
            jpwl.PWLTable(*(jnp.asarray(a) for a in arrs), name="line"))


def test_saturating_16bit_input_decodes_as_jax_does():
    """The case the dtype of the clip decides: at 16 bits (s_x = 2^-11) a
    saturating input is x_q = 32768 in bf16 and f16 (32767 rounds up in
    them) and 32767 in f32.  On y = x - 16 (zero at x_q = 32768, slope 1)
    the step shows in every dtype: y = 0 in bf16 and f16, -2^-11 in f32,
    each bitwise JAX's."""
    tt, jt = _line(1.0, -16.0)
    qt, jqt = tq.quantize_table(tt, 16, X_RANGE), jq.quantize_table(jt, 16, X_RANGE)
    assert qt.s_x == 2.0 ** -11
    want = {"float32": -(2.0 ** -11), "bfloat16": 0.0, "float16": 0.0}
    for name, (tdt, jdt) in DTYPES.items():
        x = torch.tensor([16.0, 1000.0], dtype=tdt)
        y = tq.eval_fixed_point(x, qt)
        np.testing.assert_array_equal(y.float().numpy(), _jax_eval(x, jqt, jdt))
        assert y.tolist() == [want[name]] * 2, name


def test_32bit_result_rounds_through_f32():
    """At 32 bits the float64 result goes to f32, then to x's dtype, as the
    reference's ``jnp.asarray(y, float32).astype(x.dtype)`` does.  On
    y = x + 1 + 2^-8 at x = 2^-27 (one input step) the f32 rounding lands on
    bf16's tie between 1 and 1 + 2^-7, which goes to 1.0."""
    tt, jt = _line(1.0, 1.0 + 2.0 ** -8)
    qt, jqt = tq.quantize_table(tt, 32, X_RANGE), jq.quantize_table(jt, 32, X_RANGE)
    assert qt.s_x == 2.0 ** -27
    x = torch.tensor([2.0 ** -27], dtype=torch.bfloat16)
    y = tq.eval_fixed_point(x, qt)
    assert torch.equal(y, _fixed_point_np(x, jqt)) and float(y) == 1.0


def test_tied_8bit_breakpoints_bitwise_jax():
    """8-bit tables whose breakpoints round to one integer: every input code
    of the 8-bit range and every half step between them, bitwise JAX's."""
    tied = 0
    for fn, n_bp in TABLES:
        tt, jt = _tables(fn, n_bp)
        qt, jqt = tq.quantize_table(tt, 8, X_RANGE), jq.quantize_table(jt, 8, X_RANGE)
        if not np.any(np.diff(qt.bp_q) == 0):
            continue
        tied += 1
        x = torch.from_numpy((np.arange(-129.0, 128.5, 0.5) * qt.s_x).astype(np.float32))
        for tdt, jdt in DTYPES.values():
            xd = x.to(tdt)
            np.testing.assert_array_equal(tq.eval_fixed_point(xd, qt).float().numpy(),
                                          _jax_eval(xd, jqt, jdt), err_msg=f"{fn} {n_bp}")
    assert tied >= 1


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("fn,n_bp", [("gelu", 32), ("tanh", 16), ("exp", 64), ("silu", 8)])
def test_numpy_rendering_is_jax_at_8_and_16_bits(fn, n_bp, bits):
    """The 32-bit reference rendering, run at 8 and 16 bits on f32 inputs
    (where x's dtype does not move the clip), is bitwise JAX's function."""
    tt, jt = _tables(fn, n_bp)
    qt, jqt = tq.quantize_table(tt, bits, X_RANGE), jq.quantize_table(jt, bits, X_RANGE)
    x = _inputs(qt, torch.float32)
    np.testing.assert_array_equal(_bits(_fixed_point_np(x, jqt)),
                                  _bits(torch.from_numpy(_jax_eval(x, jqt, jnp.float32))))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn,n_bp", TABLES)
def test_eval_fixed_point_32bit_bitwise_reference(fn, n_bp, dtype):
    tdt, _ = DTYPES[dtype]
    tt, jt = _tables(fn, n_bp)
    qt, jqt = tq.quantize_table(tt, 32, X_RANGE), jq.quantize_table(jt, 32, X_RANGE)
    x = _inputs(qt, tdt)
    y = tq.eval_fixed_point(x, qt)
    assert y.dtype == tdt
    np.testing.assert_array_equal(_bits(y), _bits(_fixed_point_np(x, jqt)))


@pytest.mark.parametrize("bits,tol", [(8, 0.15), (16, 1e-3), (32, 1e-5)])
def test_fixed_point_error_bounded(bits, tol):
    """TestQuantize's bounds against ``eval_coeff``, on the port."""
    table = tsfu.get_store().get(fn="gelu", n_breakpoints=32)
    qt = tq.quantize_table(table, bits, X_RANGE)
    x = tpwl.linspace_f32(-8, 8, 4097)
    assert float((tpwl.eval_coeff(x, table) - tq.eval_fixed_point(x, qt)).abs().max()) < tol


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_decode_consistency(bits):
    """TestQuantize's decode check on the port's table: the integer compare
    decode picks the float decode's segment, up to one where x quantizes
    across a breakpoint."""
    table = tsfu.get_store().get(fn="tanh", n_breakpoints=16)
    qt = tq.quantize_table(table, bits, X_RANGE)
    x = tpwl.linspace_f32(-7.9, 7.9, 1001)
    idx_f = (x[:, None] > table.bp).sum(-1)
    x_q = torch.round(x.double() / qt.s_x)
    idx_q = (x_q[:, None] > torch.from_numpy(qt.bp_q).double()).sum(-1)
    assert int(((idx_f - idx_q).abs() > 1).sum()) == 0


def test_eval_fixed_point_refuses_descending_breakpoints():
    qt = tq.quantize_table(tsfu.get_store().get(fn="gelu", n_breakpoints=8), 16, X_RANGE)
    qt.bp_q = qt.bp_q[::-1].copy()
    with pytest.raises(ValueError, match="non-decreasing"):
        tq.eval_fixed_point(torch.zeros(3), qt)


def test_quantized_table_call_and_empty_input():
    qt = tq.quantize_table(tsfu.get_store().get(fn="silu", n_breakpoints=16), 8, X_RANGE)
    x = torch.linspace(-3, 3, 7)
    assert torch.equal(qt(x), tq.eval_fixed_point(x, qt))
    for bits in (8, 32):
        qt = tq.quantize_table(tsfu.get_store().get(fn="silu", n_breakpoints=16), bits, X_RANGE)
        y = tq.eval_fixed_point(torch.zeros(0, 5, dtype=torch.bfloat16), qt)
        assert y.shape == (0, 5) and y.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the public helpers


@pytest.mark.parametrize("fmt", ["f32", "bf16", "f16", "int8"])
def test_table_to_numpy(fmt):
    tt = tsfu.get_store().get(fn="silu", n_breakpoints=32, dtype=fmt)
    jt = sfu.get_store().get(fn="silu", n_breakpoints=32, dtype=fmt)
    got, want = tpwl.table_to_numpy(tt), jpwl.table_to_numpy(jt)
    assert sorted(got) == sorted(want) and got["name"] == want["name"]
    for k in ("bp", "m", "q"):
        assert isinstance(got[k], np.ndarray)
        if fmt == "bf16":  # numpy has no bfloat16: f32, the same values
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k].astype(np.float32))
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_make_page_pool():
    want = j_make_page_pool(5, 16, 2, 64, jnp.bfloat16)
    got = make_page_pool(5, 16, 2, 64, torch.bfloat16, device="cpu")
    assert tuple(got.shape) == want.shape == (2, 5, 16, 64)
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    assert not bool(got.any())
    with pytest.raises(ValueError) as jerr:
        j_make_page_pool(1, 16, 2, 64, jnp.float32)
    with pytest.raises(ValueError) as terr:
        make_page_pool(1, 16, 2, 64, torch.float32, device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError):  # the device is explicit
        make_page_pool(4, 16, 2, 64, torch.float32)


@pytest.mark.parametrize("n_bp", BREAKPOINTS)
def test_pwl_exp_fn_bitwise_jax(n_bp):
    tt, jt = _tables("exp", n_bp)
    x = np.concatenate([np.linspace(-40, 2, 2001), [-np.inf, -1e30, -1e4, -30.5, -30.0,
                                                    -29.999, 0.0, 0.1]]).astype(np.float32)
    got = tlayers.pwl_exp_fn(tt)(torch.from_numpy(x))
    want = np.asarray(jlayers.pwl_exp_fn(jt)(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    assert bool((got >= 0).all()) and bool(torch.isfinite(got).all())


def test_pwl_exp_fn_is_resolve_exps_closure():
    """A ``jnp`` exp spec resolves to the same function as ``pwl_exp_fn``
    over the store's table."""
    from repro_torch.configs import get_config

    cfg = get_config("repro-100m", act_impl="jnp", pwl_softmax=True)
    plan = tsfu.compile_plan(cfg)
    spec = plan.get(tsfu.site_key(tsfu.SITE_SOFTMAX, "exp"))
    x = torch.linspace(-50, 1, 513)
    assert torch.equal(tlayers.resolve_exp(cfg, plan)(x),
                       tlayers.pwl_exp_fn(tsfu.get_store().get(spec))(x))


def test_port_modules_import_without_jax():
    """The new names import and run with ``jax`` and ``repro`` unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from repro_torch.core import pwl, quantize\n"
        "from repro_torch.models.layers import pwl_exp_fn\n"
        "from repro_torch.serving import make_page_pool\n"
        "from repro_torch import sfu\n"
        "t = sfu.get_store().get(fn='gelu', n_breakpoints=8)\n"
        "qt = quantize.quantize_table(t, 16, (-8.0, 8.0))\n"
        "print(quantize.eval_fixed_point(torch.linspace(-1, 1, 5), qt).shape,\n"
        "      sorted(pwl.table_to_numpy(t)), make_page_pool(2, 4, 1, 8, torch.float32,\n"
        "      device='cpu').shape)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "torch.Size([5])" in out.stdout
