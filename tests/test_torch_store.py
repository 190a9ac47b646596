"""Port parity: the ``TableStore`` (``repro_torch.sfu.store``) and
``gen_tables`` against the JAX package's on the CPU.

* The store's behaviour, as ``tests/test_sfu_plan.py``'s ``TestTableStore``
  holds JAX's: a missing artifact warns once per store and serves the
  uniform table, which a later ``get`` upgrades once the artifact appears;
  ``fit="uniform"`` is analytic and never a fallback (breakpoints within
  one ulp of 8 of JAX's uniform table); provenance is embedded and read
  back; a legacy artifact has none; fit-on-miss fits, writes and reads
  back (its MSE within 5% of JAX's same call); a non-default fingerprint
  gets its own artifact.
* Artifacts cross packages: JAX's store reads the port's ``put`` (bits and
  provenance), and the port's store reads JAX's.
* Fit-on-miss runs on ``cuda`` unless the store is told otherwise, and
  raises without a GPU: the uniform fallback is a table, never a device.
* ``gen_tables --fast --device cpu --root DIR`` writes one small pair with
  its provenance, whose ``fit_config`` has JAX's keys.

Torch runs these on one thread: a fit is thousands of small ops, which
threads only slow down.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch
import repro_torch.sfu as tsfu
from repro import sfu
from repro.core import fit as jfit
from repro.core import functions as JF
from repro.core import pwl as jpwl
from repro_torch.core import fit as tfit
from repro_torch.core import functions as TF
from repro_torch.core import gen_tables
from repro_torch.core import pwl as tpwl

FIT_ON_MISS = dict(max_steps=50, eval_every=25, max_rounds=0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t) -> np.ndarray:
    return np.asarray(t.numpy() if torch.is_tensor(t) else t, np.float32).view(np.uint32)


def test_fallback_upgrades_when_artifact_appears(tmp_path):
    store = tsfu.TableStore(root=tmp_path)
    with pytest.warns(UserWarning, match="uniform-breakpoint"):
        t_fallback = store.get(fn="gelu", n_breakpoints=8)
    uniform = tpwl.make_uniform_table(TF.get("gelu"), 8)
    np.testing.assert_array_equal(_bits(t_fallback.bp), _bits(uniform.bp))
    assert store.get(fn="gelu", n_breakpoints=8) is t_fallback  # still missing
    fitted = tsfu.get_store().get(fn="gelu", n_breakpoints=8)
    store.put(fitted)
    t_after = store.get(fn="gelu", n_breakpoints=8)
    assert not torch.equal(t_after.bp, t_fallback.bp)
    np.testing.assert_array_equal(_bits(t_after.bp), _bits(fitted.bp))
    assert store.get(fn="gelu", n_breakpoints=8) is t_after  # cached, no re-read


def test_fallback_serves_every_dtype_and_upgrades_each(tmp_path):
    store = tsfu.TableStore(root=tmp_path)
    with pytest.warns(UserWarning, match="uniform-breakpoint"):
        fb = {d: store.get(fn="silu", n_breakpoints=24, dtype=d) for d in tsfu.DTYPES}
    assert [fb[d].storage for d in tsfu.DTYPES] == list(tsfu.DTYPES)
    assert fb["bf16"].bp.dtype == torch.bfloat16
    table = tfit.fit("silu", 24, cfg=tfit.FitConfig(**FIT_ON_MISS), device="cpu").table
    store.put(table)
    for d in tsfu.DTYPES:
        want = tsfu.quantize_table(table, d)
        got = store.get(fn="silu", n_breakpoints=24, dtype=d)
        assert torch.equal(got.bp, want.bp) and torch.equal(got.m, want.m), d


def test_missing_artifact_warns_once_per_store(tmp_path):
    store = tsfu.TableStore(root=tmp_path)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        store.get(fn="gelu", n_breakpoints=8)
        store.get(fn="silu", n_breakpoints=16)   # another key: no second warning
        store.get(fn="gelu", n_breakpoints=8)    # a repeat: none either
        tsfu.TableStore(root=tmp_path).get(fn="gelu", n_breakpoints=8)  # a new store warns
    msgs = [str(w.message) for w in rec if "uniform-breakpoint" in str(w.message)]
    assert len(msgs) == 2
    assert "repro_torch.core.gen_tables" in msgs[0]


@pytest.mark.parametrize("fn", ["gelu", "silu", "exp"])
def test_uniform_fit_is_not_a_fallback(tmp_path, fn):
    store = tsfu.TableStore(root=tmp_path)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t = store.get(fn=fn, n_breakpoints=8, fit=tsfu.FIT_UNIFORM)
    assert not rec
    assert not list(tmp_path.iterdir())  # analytic: nothing read or written
    ref = tpwl.make_uniform_table(TF.get(fn), 8)
    for f in ("bp", "m", "q"):
        np.testing.assert_array_equal(_bits(getattr(t, f)), _bits(getattr(ref, f)))
    jt = sfu.TableStore(root=tmp_path).get(fn=fn, n_breakpoints=8, fit=sfu.FIT_UNIFORM)
    lo, hi = TF.get(fn).default_range
    ulp = float(np.spacing(np.float32(max(abs(lo), abs(hi)))))
    assert np.max(np.abs(t.bp.numpy().astype(np.float64) - np.asarray(jt.bp))) <= ulp
    np.testing.assert_allclose(t.m.numpy(), np.asarray(jt.m), rtol=1e-5, atol=1e-5)
    assert store.get(fn=fn, n_breakpoints=8, fit=tsfu.FIT_UNIFORM, dtype="bf16").storage == "bf16"


def test_provenance_embedded_and_readable(tmp_path):
    store = tsfu.TableStore(root=tmp_path)
    fitted = tsfu.get_store().get(fn="silu", n_breakpoints=8)
    store.put(fitted, mse=1.5e-5, mae=3e-3, extra={"range": [-8.0, 8.0]})
    prov = store.provenance("silu", 8)
    assert prov["schema"] == tsfu.store.PROVENANCE_SCHEMA == 1
    assert prov["fn"] == "silu"
    assert prov["n_breakpoints"] == 8
    assert prov["n_segments"] == 9
    assert prov["fit"] == tsfu.DEFAULT_FIT
    assert prov["mse"] == pytest.approx(1.5e-5)
    assert prov["mae"] == pytest.approx(3e-3)
    assert prov["range"] == [-8.0, 8.0]
    assert prov["repro_version"] == repro_torch.__version__ and "created_unix" in prov
    with np.load(store.artifact_path("silu", 8)) as data:
        assert sorted(data.files) == ["bp", "m", "mae", "mse", "provenance", "q"]
        assert all(data[k].dtype == np.float32 for k in ("bp", "m", "q"))
        assert float(data["mse"]) == 1.5e-5
    t = store.get(fn="silu", n_breakpoints=8)
    np.testing.assert_array_equal(_bits(t.bp), _bits(fitted.bp))


def test_legacy_artifact_without_provenance(tmp_path):
    store = tsfu.TableStore()
    assert store.get(fn="gelu", n_breakpoints=32) is not None
    assert store.provenance("gelu", 32) is None
    assert tsfu.TableStore(root=tmp_path).provenance("gelu", 32) is None  # no artifact


def test_fit_on_miss_matches_jax(tmp_path):
    store = tsfu.TableStore(root=tmp_path / "torch", fit_on_miss=True,
                            fit_config=tfit.FitConfig(**FIT_ON_MISS), fit_device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t = store.get(fn="tanh", n_breakpoints=4)
    assert not [w for w in rec if "uniform-breakpoint" in str(w.message)]
    assert store.artifact_path("tanh", 4).exists()
    prov = store.provenance("tanh", 4)
    assert prov["trigger"] == "fit-on-miss"
    assert prov["range"] == [-8.0, 8.0]
    assert t.n_breakpoints == 4 and bool(torch.all(t.bp[1:] > t.bp[:-1]))
    jstore = sfu.TableStore(root=tmp_path / "jax", fit_on_miss=True,
                            fit_config=jfit.FitConfig(**FIT_ON_MISS))
    jstore.get(fn="tanh", n_breakpoints=4)
    assert prov["mse"] == pytest.approx(jstore.provenance("tanh", 4)["mse"], rel=0.05)
    # the fitted table beats the uniform one it started from
    assert prov["mse"] < tpwl.mse(tpwl.make_uniform_table(TF.get("tanh"), 4), TF.get("tanh"),
                                  -8.0, 8.0)


def test_fit_on_miss_runs_on_cuda_unless_told(tmp_path, monkeypatch):
    store = tsfu.TableStore(root=tmp_path, fit_on_miss=True,
                            fit_config=tfit.FitConfig(**FIT_ON_MISS))
    assert store.fit_device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        store.get(fn="tanh", n_breakpoints=4)
    assert not store.artifact_path("tanh", 4).exists()


def test_non_default_fit_fingerprint_gets_own_artifact(tmp_path):
    store = tsfu.TableStore(root=tmp_path)
    fitted = tsfu.get_store().get(fn="gelu", n_breakpoints=8)
    p = store.put(fitted, fit="exp-sweep")
    assert "exp-sweep" in p.name
    assert p != store.artifact_path("gelu", 8)
    assert store.provenance("gelu", 8, fit="exp-sweep")["fit"] == "exp-sweep"
    assert torch.equal(store.get(fn="gelu", n_breakpoints=8, fit="exp-sweep").bp, fitted.bp)


def test_fit_and_put_records_the_config(tmp_path):
    cfg = tfit.FitConfig(**FIT_ON_MISS)
    store = tsfu.TableStore(root=tmp_path, fit_device="cpu")
    r = store.fit_and_put("sigmoid", 4, fit_config=cfg)
    prov = store.provenance("sigmoid", 4)
    assert prov["fit_config"] == {**dataclasses.asdict(cfg), "betas": [0.9, 0.999]}
    assert prov["mse"] == pytest.approx(r.mse)
    np.testing.assert_array_equal(_bits(store.get(fn="sigmoid", n_breakpoints=4).bp),
                                  _bits(r.table.bp))


def test_port_artifact_read_by_jax(tmp_path):
    table = tfit.fit("gelu_tanh", 6, cfg=tfit.FitConfig(**FIT_ON_MISS), device="cpu").table
    tsfu.TableStore(root=tmp_path).put(table, mse=2.5e-4, mae=1e-2,
                                       extra={"range": [-8.0, 8.0], "trigger": "test"})
    jstore = sfu.TableStore(root=tmp_path)
    jt = jstore.get(fn="gelu_tanh", n_breakpoints=6)
    for f in ("bp", "m", "q"):
        np.testing.assert_array_equal(_bits(np.asarray(getattr(jt, f))), _bits(getattr(table, f)))
    prov = jstore.provenance("gelu_tanh", 6)
    assert prov["fn"] == "gelu_tanh" and prov["n_segments"] == 7
    assert prov["mse"] == 2.5e-4 and prov["trigger"] == "test"
    # and the JAX evaluation of the port's fit is the port's
    x = np.linspace(-9, 9, 513, dtype=np.float32)
    np.testing.assert_allclose(tpwl.eval_coeff(torch.from_numpy(x), table).numpy(),
                               np.asarray(jpwl.eval_coeff(x, jt)), rtol=1e-6, atol=1e-6)


def test_jax_artifact_read_by_port(tmp_path):
    jtable = jpwl.make_uniform_table(JF.get("softplus"), 12)
    sfu.TableStore(root=tmp_path).put(jtable, mse=1e-4, extra={"note": "jax"})
    store = tsfu.TableStore(root=tmp_path)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t = store.get(fn="softplus", n_breakpoints=12)
    assert not rec
    for f in ("bp", "m", "q"):
        np.testing.assert_array_equal(_bits(getattr(t, f)), _bits(np.asarray(getattr(jtable, f))))
    prov = store.provenance("softplus", 12)
    assert prov["note"] == "jax" and prov["mse"] == 1e-4 and prov["n_breakpoints"] == 12


def test_gen_tables_writes_to_root_on_the_asked_device(tmp_path, capsys):
    assert gen_tables.FUNCTIONS == ["gelu", "gelu_tanh", "silu", "sigmoid", "tanh", "exp",
                                    "softplus", "hardswish"]
    assert gen_tables.BREAKPOINTS == [8, 16, 32, 64]
    for fast in (True, False):  # both configurations are JAX's
        want = (jfit.FitConfig(max_steps=1000, max_rounds=2, init="curvature") if fast
                else jfit.FitConfig(max_steps=4000, max_rounds=6, init="curvature"))
        assert dataclasses.asdict(gen_tables.fit_config(fast)) == dataclasses.asdict(want)
    gen_tables.main(["--fast", "--functions", "sigmoid", "--breakpoints", "4",
                     "--device", "cpu", "--root", str(tmp_path)])
    assert "sigmoid" in capsys.readouterr().out
    assert [p.name for p in tmp_path.iterdir()] == ["sigmoid_4bp.npz"]
    prov = tsfu.TableStore(root=tmp_path).provenance("sigmoid", 4)
    assert prov["generator"] == "repro_torch.core.gen_tables"
    assert set(prov["fit_config"]) == set(dataclasses.asdict(jfit.FitConfig()))
    assert prov["fit_config"]["init"] == "curvature" and prov["fit_config"]["max_steps"] == 1000
    assert prov["range"] == [-8.0, 8.0] and prov["fit"] == tsfu.DEFAULT_FIT
    assert {"schema", "fn", "n_breakpoints", "n_segments", "repro_version", "created_unix",
            "mse", "mae"} <= set(prov)
    jt = sfu.TableStore(root=tmp_path).get(fn="sigmoid", n_breakpoints=4)  # JAX reads it
    uniform = jpwl.mse(jpwl.make_uniform_table(JF.get("sigmoid"), 4), JF.get("sigmoid"),
                       -8.0, 8.0)
    assert jpwl.mse(jt, JF.get("sigmoid"), -8.0, 8.0) < uniform
    assert prov["mse"] == pytest.approx(jpwl.mse(jt, JF.get("sigmoid"), -8.0, 8.0), rel=1e-3)


def test_gen_tables_defaults_to_cuda_and_the_shipped_root(monkeypatch):
    args = gen_tables.build_parser().parse_args([])
    assert args.device == "cuda" and args.root == str(tsfu.TABLE_DIR) and not args.fast
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        gen_tables.main(["--functions", "tanh", "--breakpoints", "4"])
