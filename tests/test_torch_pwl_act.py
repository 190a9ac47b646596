"""Port parity: the standalone PWL activation (``repro_torch.kernels.ops``,
TPU kernels 19 and 20), its oracles and the table tools of ``core.pwl``
against the JAX package, and the ``impl="kernel"`` plan through a model.

On the CPU each wrapper takes its kernel's plain version; the JAX side runs
its Pallas kernels in interpret mode, as the JAX suite does.

* Kernel 19 at 4..64 breakpoints (``tests/test_kernels.py``), x in f32 and
  bf16, tables in f32, bf16, f16 and int8, and kernel 20 (sigmoid, 32
  breakpoints, 32 x 384): rtol 1e-5, atol 1e-6 (XLA contracts m·x + q into
  one FMA, the port rounds twice, as its CUDA kernel does).
* Inputs exactly on every breakpoint and every uniform segment edge, with
  tables whose segments do not meet (random m, q), so a wrong segment
  shows (off by O(1), against 1e-5): the chosen segment is JAX's.  Past
  2^31 segment widths the JAX kernel's int32 index overflows; the port's
  f32 index takes the boundary segment there.
* ``make_uniform_table``, ``eval_interp``, ``mse``, ``mae`` and the three
  oracles of ``kernels/ref.py`` against JAX's.
* The bf16/f16 native operand layout and the f32 delta layout that CUDA
  reads decode bitwise alike, breakpoints included.
* Neither wrapper takes a gradient (the JAX kernel has no VJP), and the
  train launcher refuses an ``impl="kernel"`` plan.
* Reduced repro-100m under the ``impl="kernel"`` plan against JAX's logits
  at 1e-4, and the serve launcher on the CPU under that plan.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.core import functions as JF
from repro.core import pwl as jpwl
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused import epilogue as jepi
from repro.models import Model as JModel
from repro_torch.configs import get_reduced_config
from repro_torch.core import functions as TF
from repro_torch.core import pwl as tpwl
from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pwl_act
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused import epilogue as tepi
from repro_torch.models import Model, params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
FORMATS = ["f32", "bf16", "f16", "int8"]


def _x(seed, shape, scale=5.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("n_bp", [4, 8, 16, 32, 64])
def test_nonuniform_plain_matches_jax_breakpoint_counts(n_bp):
    jt = jpwl.make_uniform_table(JF.get("tanh"), n_bp)
    tt = tpwl.make_uniform_table(TF.get("tanh"), n_bp)
    x = np.linspace(-10, 10, 2048, dtype=np.float32).reshape(8, 256)
    want = jops.pwl_activation(jnp.asarray(x), jt)
    got = tops.pwl_activation(torch.from_numpy(x), tt)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_nonuniform_plain_matches_jax_formats(fmt, xdtype):
    jt = sfu.get_store().get(fn="gelu", n_breakpoints=32, dtype=fmt)
    tt = tsfu.get_store().get(fn="gelu", n_breakpoints=32, dtype=fmt)
    x = _x(0, (3, 257))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if xdtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jops.pwl_activation(jx, jt)
    got = tops.pwl_activation(tx, tt)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL)


@pytest.mark.parametrize("fmt", ["bf16", "f16"])
def test_table_dtype_argument_quantizes_first(fmt):
    jt = sfu.get_store().get(fn="silu", n_breakpoints=16)
    tt = tsfu.get_store().get(fn="silu", n_breakpoints=16)
    x = _x(1, (2, 5, 7, 33))
    want = jops.pwl_activation(jnp.asarray(x), jt, table_dtype=fmt)
    got = tops.pwl_activation(torch.from_numpy(x), tt, table_dtype=fmt)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_uniform_plain_matches_jax():
    jspec, tspec = JF.get("sigmoid"), TF.get("sigmoid")
    jt, tt = jpwl.make_uniform_table(jspec, 32), tpwl.make_uniform_table(tspec, 32)
    lo, hi = tspec.default_range
    x = _x(2, (32, 384), 6.0)
    want = jops.pwl_activation_uniform(jnp.asarray(x), jt.m, jt.q, lo, hi)
    got = tops.pwl_activation_uniform(torch.from_numpy(x), tt.m, tt.q, lo, hi)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want_b = jops.pwl_activation_uniform(jnp.asarray(x).astype(jnp.bfloat16), jt.m, jt.q, lo,
                                         hi)
    got_b = tops.pwl_activation_uniform(xb, tt.m, tt.q, lo, hi)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(), _np(want_b), **TOL)


def _ragged_table(n_bp, seed):
    """Sorted breakpoints with random, discontinuous segments: an input
    decoded into a neighbouring segment gives a visibly different value."""
    rng = np.random.default_rng(seed)
    bp = np.sort(rng.uniform(-6, 6, n_bp)).astype(np.float32)
    m = rng.uniform(-2, 2, n_bp + 1).astype(np.float32)
    q = rng.uniform(-3, 3, n_bp + 1).astype(np.float32)
    return bp, m, q


@pytest.mark.parametrize("n_bp", [4, 32, 64])
def test_breakpoints_belong_to_the_jax_segment(n_bp):
    bp, m, q = _ragged_table(n_bp, n_bp)
    jt = jpwl.PWLTable(jnp.asarray(bp), jnp.asarray(m), jnp.asarray(q))
    tt = PWLTable(torch.from_numpy(bp), torch.from_numpy(m), torch.from_numpy(q))
    x = np.concatenate([bp, np.nextafter(bp, np.inf), np.nextafter(bp, -np.inf)])
    want = _np(jops.pwl_activation(jnp.asarray(x), jt))
    got = tops.pwl_activation(torch.from_numpy(x), tt).numpy()
    # a neighbouring segment is off by O(1); m·x + q rounded once (XLA's
    # FMA) or twice (the port) differs by an ulp of terms up to ~20
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # on bp_i the segment ending there: m_i, q_i
    np.testing.assert_allclose(got[:n_bp], m[:-1] * bp + q[:-1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_seg", [3, 17, 65])
def test_uniform_segment_edges_belong_to_the_jax_segment(n_seg):
    _, m, q = _ragged_table(n_seg - 1, 100 + n_seg)
    lo, hi = -3.0, 5.0
    h = (hi - lo) / (n_seg - 2)
    edges = (lo + h * np.arange(-1, n_seg)).astype(np.float32)
    x = np.concatenate([edges, np.nextafter(edges, np.inf), np.nextafter(edges, -np.inf)])
    want = _np(jops.pwl_activation_uniform(jnp.asarray(x), jnp.asarray(m), jnp.asarray(q),
                                           lo, hi))
    got = tops.pwl_activation_uniform(torch.from_numpy(x), torch.from_numpy(m),
                                      torch.from_numpy(q), lo, hi).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # past 2^31 segment widths the TPU kernel's int32 index overflows (its
    # +inf lands in segment 0); the port clips in f32: the boundary segments
    far = np.float32([-1e30, 1e30])
    got = tops.pwl_activation_uniform(torch.from_numpy(far), torch.from_numpy(m),
                                      torch.from_numpy(q), lo, hi).numpy()
    np.testing.assert_allclose(got, m[[0, -1]] * far + q[[0, -1]], rtol=1e-6)


def test_uniform_constants_are_the_f32_roundings():
    lo, inv_h = pwl_act.uniform_constants(-8.0, 8.0, 33)
    assert lo == -8.0 and inv_h == float(np.float32(31 / 16.0))
    _, inv_h = pwl_act.uniform_constants(-3.0, 0.1, 34)
    assert inv_h == float(np.float32(32 / 3.1)) != 32 / 3.1


# gelu is left out: XLA's erf is ~1e-6 off torch's in gelu's tails, which the
# slopes of the tail segments divide by their width
@pytest.mark.parametrize("fn", ["silu", "tanh", "exp"])
@pytest.mark.parametrize("n_bp", [8, 32])
def test_make_uniform_table_matches_jax(fn, n_bp):
    jt = jpwl.make_uniform_table(JF.get(fn), n_bp)
    tt = tpwl.make_uniform_table(TF.get(fn), n_bp)
    # the port's breakpoints are the f32 roundings of the evenly spaced
    # points (jnp.linspace is up to ~5e-7 off them): absolute 1e-5 on
    # values up to 8
    for a, b in ((tt.bp, jt.bp), (tt.m, jt.m), (tt.q, jt.q)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)
    assert tt.name == fn
    spec_j, spec_t = JF.get(fn), TF.get(fn)
    lo, hi = spec_t.default_range
    np.testing.assert_allclose(tpwl.mse(tt, spec_t, lo, hi), jpwl.mse(jt, spec_j, lo, hi),
                               rtol=1e-3)
    np.testing.assert_allclose(tpwl.mae(tt, spec_t, lo, hi), jpwl.mae(jt, spec_j, lo, hi),
                               rtol=1e-4)


def test_eval_interp_and_params_to_coeffs_match_jax():
    rng = np.random.default_rng(3)
    p = np.sort(rng.uniform(-4, 4, 12)).astype(np.float32)
    v = rng.standard_normal(12).astype(np.float32)
    x = np.concatenate([_x(4, (300,), 3.0), p])
    want = jpwl.eval_interp(jnp.asarray(x), jnp.asarray(p), jnp.asarray(v), 0.25, -0.5)
    got = tpwl.eval_interp(torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(v),
                           0.25, -0.5)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    jt = jpwl.params_to_coeffs(jnp.asarray(p), jnp.asarray(v), 0.25, -0.5)
    tt = tpwl.params_to_coeffs(torch.from_numpy(p), torch.from_numpy(v), 0.25, -0.5)
    np.testing.assert_allclose(tt.m.numpy(), _np(jt.m), **TOL)
    np.testing.assert_allclose(tt.q.numpy(), _np(jt.q), **TOL)
    # the coefficient form evaluates the interpolation form
    np.testing.assert_allclose(tpwl.eval_coeff(torch.from_numpy(x), tt).numpy(), got.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["f32", "bf16"])
def test_refs_match_jax(fmt):
    jt = sfu.get_store().get(fn="exp", n_breakpoints=32, dtype=fmt)
    tt = tsfu.get_store().get(fn="exp", n_breakpoints=32, dtype=fmt)
    x = _x(5, (4, 6, 50), 3.0)
    np.testing.assert_allclose(tref.pwl_activation_ref(torch.from_numpy(x), tt).numpy(),
                               _np(jref.pwl_activation_ref(jnp.asarray(x), jt)), **TOL)
    np.testing.assert_allclose(tref.pwl_softmax_ref(torch.from_numpy(x), tt).numpy(),
                               _np(jref.pwl_softmax_ref(jnp.asarray(x), jt)), **TOL)
    spec = TF.get("sigmoid")
    ju = jpwl.make_uniform_table(JF.get("sigmoid"), 32)
    tu = tpwl.make_uniform_table(spec, 32)
    if fmt == "bf16":
        ju = jpwl.PWLTable(ju.bp, ju.m.astype(jnp.bfloat16), ju.q.astype(jnp.bfloat16))
        tu = PWLTable(tu.bp, tu.m.to(torch.bfloat16), tu.q.to(torch.bfloat16))
    lo, hi = spec.default_range
    want = jref.pwl_activation_uniform_ref(jnp.asarray(x), lo, hi, ju.m, ju.q)
    got = tref.pwl_activation_uniform_ref(torch.from_numpy(x), lo, hi, tu.m, tu.q)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("fmt", ["bf16", "f16"])
@pytest.mark.parametrize("fn", ["gelu_tanh", "exp", "silu"])
def test_native_and_delta_layouts_decode_bitwise(fn, fmt):
    """What the CUDA kernels read for a bf16/f16 table (the f32 delta
    layout, packed off the CPU) decodes bit for bit as the native layout,
    value and slope, on every breakpoint (left segment), its neighbours and
    a grid."""
    t = tsfu.get_store().get(fn=fn, n_breakpoints=32, dtype=fmt)
    native = tepi.pack_table(t)
    delta = tepi.pack_table(t, native=False)
    assert native[1].dtype != torch.float32 and delta[1].dtype == torch.float32
    cuda_layout = tepi.pack_for(t, "meta")
    assert cuda_layout[1].dtype == torch.float32 and cuda_layout[1].shape == delta[1].shape
    bp = t.bp.to(torch.float32)
    x = torch.cat([bp, torch.nextafter(bp, torch.tensor(np.inf)),
                   torch.nextafter(bp, torch.tensor(-np.inf)),
                   torch.linspace(-12, 12, 257)])
    vn, sn = tepi.pwl_value_and_slope(x, *native, 32)
    vd, sd = tepi.pwl_value_and_slope(x, *delta, 32)
    assert torch.equal(vn.view(torch.int32), vd.view(torch.int32))
    assert torch.equal(sn.view(torch.int32), sd.view(torch.int32))
    # and the standalone kernel's plain version on either layout
    yn = pwl_act.pwl_nonuniform_plain(x, *native)
    yd = pwl_act.pwl_nonuniform_plain(x, *delta)
    assert torch.equal(yn.view(torch.int32), yd.view(torch.int32))
    # the left segment owns a breakpoint: its slope is m_i
    assert torch.equal(sd[:32], t.m[:-1].to(torch.float32))


@pytest.mark.parametrize("which", ["nonuniform", "uniform"])
def test_no_gradient_through_the_standalone_kernel(which):
    t = tsfu.get_store().get(fn="gelu", n_breakpoints=32)
    x = torch.randn(4, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        if which == "nonuniform":
            tops.pwl_activation(x, t)
        else:
            tops.pwl_activation_uniform(x, t.m, t.q, -8.0, 8.0)
    with torch.no_grad():  # serving: no graph, no refusal
        tops.pwl_activation(x, t)


def _kernel_plan_file(tmp_path):
    plan = tsfu.compile_plan(get_reduced_config("repro-100m", act_impl="kernel"))
    assert {k: s.impl for k, s in plan.items()} == {"mlp:gelu_tanh": "kernel"}
    return str(tsfu.dump_plan(plan, tmp_path / "kernel_plan.json"))


def test_train_launcher_refuses_a_kernel_plan(tmp_path):
    from repro_torch.launch import train

    args = train.build_parser().parse_args(["--reduced", "--device", "cpu", "--steps", "1",
                                            "--plan", _kernel_plan_file(tmp_path)])
    with pytest.raises(ValueError, match="impl='kernel'.*no backward"):
        train.run(args)


def test_reduced_model_under_the_kernel_plan_matches_jax():
    jcfg = j_get_reduced_config("repro-100m", act_impl="kernel", dtype=jnp.float32)
    tcfg = get_reduced_config("repro-100m", act_impl="kernel", dtype=torch.float32)
    jmodel = JModel(jcfg)
    import jax

    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    toks = np.random.default_rng(6).integers(0, 512, size=(2, 24)).astype(np.int32)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    got = Model(tcfg, device="cpu").forward(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_serve_on_cpu_under_the_kernel_plan(tmp_path, capsys):
    from repro_torch.launch import serve

    path = _kernel_plan_file(tmp_path)
    assert json.loads(open(path).read())["sites"][0][1]["impl"] == "kernel"
    rc = serve.serve(["--reduced", "--device", "cpu", "--plan", path, "--batch", "2",
                      "--prompt-len", "12", "--max-new", "3"])
    assert rc == 0
    assert "'mlp:gelu_tanh': 'kernel'" in capsys.readouterr().out
