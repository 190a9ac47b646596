"""Port parity: the logical sharding rules (``repro_torch.distributed``,
``repro_torch.launch.steps``) against the JAX package's, with no process
group: JAX computes its rules on a ``jax.sharding.AbstractMesh``, the port on
its ``AbstractMesh`` of the same axes.

* ``make_rules`` and ``make_cell_rules`` tables, ``specs_for_params`` over
  ``Model.param_logical()``, ``batch_specs`` and ``auto_microbatches`` equal
  JAX's for every arch (full width, and the reduced config of the archs
  refused at full width), every ``SHAPE_CELLS`` cell and the meshes (2, 2),
  (16, 16) and (2, 16, 16).
* ``logical_specs`` equals JAX's ``Model.param_logical()`` for every arch.
* ``shard_spec`` / ``sanitize_spec`` on dims the mesh does not divide
  (whisper's 1500 frames, S = 1), with the warn-once check.
* ``active_mesh_rules`` is None for a one-rank mesh; spec -> DTensor
  placements.
"""
import importlib
import warnings

import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from torch.distributed.tensor import Replicate, Shard

import repro  # noqa: F401
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.distributed import shard_fused as jshf
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import Model as JModel
from repro.models import SHAPE_CELLS as JAX_CELLS
from repro_torch.configs import ARCH_IDS, REDUCED_ONLY, get_config, get_reduced_config
from repro_torch.distributed import shard_fused as shf
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps
from repro_torch.models import SHAPE_CELLS, Model

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ALL_ARCHS = list(ARCH_IDS) + list(REDUCED_ONLY)
# every arch at full width, and the reduced config of the archs refused there
ARCHS = [(a, False) for a in ALL_ARCHS] + [(a, True) for a in REDUCED_ONLY]
ARCH_IDS_ = [a + ("-reduced" if r else "") for a, r in ARCHS]


def _configs(arch, reduced):
    if reduced:
        return get_reduced_config(arch), jax_reduced(arch)
    if arch in REDUCED_ONLY:  # refused at full width by get_config; its fields still hold
        name = arch.replace("-", "_").replace(".", "_")
        return importlib.import_module(f"repro_torch.configs.{name}").CONFIG, jax_config(arch)
    return get_config(arch), jax_config(arch)


def _meshes(name):
    sizes, axes = MESHES[name]
    return sh.AbstractMesh(sizes, axes), JAbstractMesh(sizes, axes)


def _flat(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists, any other value a leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, path + (i,))]
    return [(path, tree)]


def _spec(p):
    """A port or JAX spec as a plain tuple of entries."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,reduced", ARCHS, ids=ARCH_IDS_)
def test_make_rules_table_equals_jax(arch, reduced, mesh):
    tc, jc = _configs(arch, reduced)
    tm, jm = _meshes(mesh)
    got, want = sh.make_rules(tc, tm), jsh.make_rules(jc, jm)
    assert got.table == want.table
    assert got.mesh_axes == tuple(want.mesh_axes)


@pytest.mark.parametrize("cell", list(SHAPE_CELLS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,reduced", ARCHS, ids=ARCH_IDS_)
def test_cell_rules_param_and_batch_specs_equal_jax(arch, reduced, mesh, cell):
    """make_cell_rules' table, specs_for_params over param_logical() and
    batch_specs, for one (arch, mesh, cell)."""
    tc, jc = _configs(arch, reduced)
    tm, jm = _meshes(mesh)
    got = steps.make_cell_rules(tc, tm, SHAPE_CELLS[cell])
    want = jsteps.make_cell_rules(jc, jm, JAX_CELLS[cell])
    assert got.table == want.table
    tspecs = _flat(sh.specs_for_params(got, Model(tc, device="cpu").param_logical()))
    jspecs = _flat(jsh.specs_for_params(want, JModel(jc).param_logical()))
    assert [p for p, _ in tspecs] == [p for p, _ in jspecs]
    for (path, t), (_, j) in zip(tspecs, jspecs):
        assert isinstance(t, sh.P)
        assert _spec(t) == _spec(j), path
    tb = steps.batch_specs(tc, SHAPE_CELLS[cell], got)
    jb = jsteps.batch_specs(jc, JAX_CELLS[cell], want)
    assert sorted(tb) == sorted(jb)
    for k in tb:
        assert _spec(tb[k]) == _spec(jb[k]), k


@pytest.mark.parametrize("cell", list(SHAPE_CELLS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,reduced", ARCHS, ids=ARCH_IDS_)
def test_auto_microbatches_equal_jax(arch, reduced, mesh, cell):
    tc, jc = _configs(arch, reduced)
    tm, jm = _meshes(mesh)
    assert (steps.auto_microbatches(tc, SHAPE_CELLS[cell], tm)
            == jsteps.auto_microbatches(jc, JAX_CELLS[cell], jm))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_logical_specs_equal_jax(arch):
    tc, jc = get_reduced_config(arch), jax_reduced(arch)
    got = _flat(Model(tc, device="cpu").param_logical())
    want = _flat(JModel(jc).param_logical())
    assert got == [(p, tuple(a)) for p, a in want]


@pytest.mark.parametrize("force", [None, False, True])
def test_force_dp_only_drops_tensor_parallelism(force):
    """repro-100m (< 2.5 B parameters, no experts) trains fully data
    parallel by default, and keeps tensor parallelism with
    force_dp_only=False, as in JAX."""
    tc = get_config("repro-100m", force_dp_only=force)
    jc = jax_config("repro-100m").__class__(**{**jax_config("repro-100m").__dict__,
                                              "force_dp_only": force})
    tm, jm = _meshes("2x2")
    got = steps.make_cell_rules(tc, tm, SHAPE_CELLS["train_4k"])
    assert got.table == jsteps.make_cell_rules(jc, jm, JAX_CELLS["train_4k"]).table
    dp_only = force is not False
    assert (got.table["mlp"] is None) == dp_only
    assert got.table["batch"] == (("data", "model") if dp_only else ("data",))


def test_sanitize_spec_replicates_non_dividing_dims_and_warns_once():
    """Whisper's 1500 frames over 16 replicate, warned once per (entry,
    shape); S = 1 replicates without a warning; the result equals JAX's."""
    tm, jm = _meshes("16x16")
    cases = [(sh.P("data", None, "model"), (32, 1500, 768)),
             (sh.P(None, "data", None), (32, 1500, 768)),
             (sh.P("data", "model", None), (32, 1, 768)),
             (sh.P(("data", "model"), None), (4096, 7))]
    sh.reset_sanitize_warnings()
    jsh.reset_sanitize_warnings()
    for spec, shape in cases:
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = sh.sanitize_spec(tm, spec, shape)
            again = sh.sanitize_spec(tm, spec, shape)
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = jsh.sanitize_spec(jm, jsh.P(*spec), shape)
        assert _spec(got) == _spec(want) == _spec(again)
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
        dropped = [d for d, (a, b) in enumerate(zip(spec, got)) if a != b]
        assert len(tw) == (1 if any(shape[d] > 1 for d in dropped) else 0)


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2.5-32b", "repro-100m", "olmoe-1b-7b"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_spec_equals_jax(arch, mesh):
    """shard_spec of the fused sites' operands (frames of 1500, S = 1
    decode, heads that do not divide 16) equals JAX's."""
    tc, jc = get_config(arch), jax_config(arch)
    tm, jm = _meshes(mesh)
    tr, jr = sh.make_rules(tc, tm), jsh.make_rules(jc, jm)
    H, Hkv, dh = tc.n_heads, tc.n_kv_heads, tc.resolved_head_dim
    operands = [(("batch", None, "act_embed"), (32, 1500, tc.d_model)),
                (("batch", "act_seq", "act_heads", None), (32, 1, H, dh)),
                (("batch", "act_seq", "act_kv", None), (8, 4096, Hkv, dh)),
                (("cache_kv", None, None, None), (Hkv, 64, 16, dh)),
                ((None, "mlp"), (tc.d_model, tc.d_ff)),
                (("batch", None, "mlp"), (3, 5, tc.d_ff))]
    for axes, shape in operands:
        assert _spec(shf.shard_spec(tr, axes, shape)) == _spec(jshf.shard_spec(jr, axes, shape))
        assert shf.batch_entry(tr, shape[0]) == jshf.batch_entry(jr, shape[0])
    assert shf.mesh_axis_sizes(tr) == dict(jshf.mesh_axis_sizes(jr))


def test_local_shape_of_qwen_on_the_production_mesh():
    """qwen2.5-32b's 40 heads do not divide 16: sequence-parallel rules,
    whole heads on every rank, the cache's sequence over "model"."""
    tm, _ = _meshes("16x16")
    rules = sh.make_rules(get_config("qwen2.5-32b"), tm)
    assert rules.table["act_heads"] is None and rules.table["cache_seq"] == "model"
    spec = shf.shard_spec(rules, ("batch", "act_seq", "act_heads", None), (32, 4096, 40, 128))
    assert shf.local_shape(rules, spec, (32, 4096, 40, 128)) == (2, 4096, 40, 128)
    spec = shf.shard_spec(rules, (None, "mlp"), (5120, 27648))
    assert shf.local_shape(rules, spec, (5120, 27648)) == (5120, 1728)


def test_active_mesh_rules_none_for_one_rank():
    cfg = get_reduced_config("repro-100m")
    assert sh.active_mesh_rules() is None
    with sh.use_rules(sh.make_rules(cfg, sh.AbstractMesh((1, 1), ("data", "model")))):
        assert sh.active_rules() is not None
        assert sh.active_mesh_rules() is None
    with sh.use_rules(sh.Rules(table={}, mesh_axes=("data",))):
        assert sh.active_mesh_rules() is None
    rules = sh.make_rules(cfg, sh.AbstractMesh((2, 2), ("data", "model")))
    with sh.use_rules(rules):
        assert sh.active_mesh_rules() is rules
    assert sh.active_rules() is None


def test_spec_to_placements():
    mesh = sh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    spec = sh.P(("pod", "data"), None, "model")
    pl = sh.placements(mesh, spec)
    assert pl == [Shard(0), Shard(0), Shard(2)]
    assert sh.placements(mesh, sh.P(None, None)) == [Replicate()] * 3
    assert sh.placements(mesh, sh.P("data")) == [Replicate(), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="order"):
        sh.placements(mesh, sh.P(("model", "data")))


def test_constrain_is_a_no_op_without_rules_or_dtensors():
    import torch

    x = torch.ones(4, 4)
    assert sh.constrain(x, "batch", None) is x
    with sh.use_rules(sh.make_rules(get_reduced_config("repro-100m"),
                                    sh.AbstractMesh((2, 2), ("data", "model")))):
        assert sh.constrain(x, "batch", None) is x
