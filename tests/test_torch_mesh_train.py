"""The sharded train step of the port on a (data=2, model=2) mesh: four
gloo ranks on the CPU (``tests/torch_mesh_workers.py``), f32, held against
the port's own single-process step (which the other ``test_torch_*`` files
hold against JAX; the JAX package's own sharded path raises
``ShardingTypeError`` on JAX 0.9.0, so it cannot be the reference here).

* Models (``TRAIN_CASES``): reduced repro-100m under the fused plan with
  the fused softmax, with ``force_dp_only=False`` (tensor parallel; also in
  two microbatches) and at its default (fully data parallel); reduced olmoe-1b-7b and phi3.5-moe,
  experts parallel over "model"; reduced mamba2-2.7b, ``ssm_inner`` over
  "model"; reduced whisper-small, tensor parallel.
* The loss and every gradient leaf within 1e-4 of the leaf's max of the
  single-process step's (reduced whisper, which amplifies f32 rounding:
  within 4x the single-process step's own gap to its f64 run where that
  passes 1e-4).  An MoE layer's capacity and aux loss are per data shard,
  as in JAX, so the MoE models' reference is the mean of the
  single-process step over the two data shards' rows.
* Parameters, both AdamW moments and the gradients placed as
  ``specs_for_params`` says, before and after a step; every fused call
  takes plain tensors of its local shapes; no fused fallback.
* A DTensor handed straight to a fused wrapper raises; the MoE combine's
  gradient (tokens, router, experts) against the per-shard reference.
* The launcher: ``torchrun --nproc-per-node 4 -m repro_torch.launch.train
  --device cpu --reduced --model-parallel 2`` for 3 steps and a resume to 5
  give the checkpoint of 5 straight steps, bit for bit.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from torch_mesh_utils import SRC, run_ranks
from torch_mesh_workers import TRAIN_CASES

TOL = 1e-4
# (fused wrapper, its first two operands' local shapes), per case: batch
# 4 x 32 over the data axes, heads / d_ff / experts over "model"
LOCAL_SHAPES = {
    "repro-100m-tp": {("fused_glu", (2, 32, 64), (64, 64)),
                      ("fused_pwl_softmax", (2, 1, 2, 32, 32), None)},
    "repro-100m-tp-2mb": {("fused_glu", (1, 32, 64), (64, 64)),
                          ("fused_pwl_softmax", (1, 1, 2, 32, 32), None)},
    "repro-100m-dp": {("fused_glu", (1, 32, 64), (64, 128)),
                      ("fused_pwl_softmax", (1, 1, 4, 32, 32), None)},
    "olmoe-1b-7b": {("fused_moe_glu", (4, 20, 64), (4, 64, 64))},
    "phi3.5-moe": {("fused_moe_glu", (2, 40, 64), (2, 64, 64))},
    "mamba2-2.7b": set(),
    "whisper-small": {("fused_linear", (2, 24, 64), (64, 64)),
                      ("fused_linear", (2, 32, 64), (64, 64)),
                      ("fused_pwl_softmax", (2, 1, 2, 24, 24), None),
                      ("fused_pwl_softmax", (2, 1, 2, 32, 24), None),
                      ("fused_pwl_softmax", (2, 1, 2, 32, 32), None)},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("train_all", tmp_path_factory.mktemp("mesh_train"), timeout=400)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_loss_matches_single_process(runs, case, rank):
    r = runs[rank][case]
    assert abs(r["loss"] - r["ref_loss"]) <= TOL * max(1.0, abs(r["ref_loss"]))
    assert r["step_loss"] == r["loss"]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_every_gradient_leaf_matches_single_process(runs, case):
    r = runs[0][case]
    for (path, err), yard in zip(r["grad_errs"], r["yardstick"], strict=True):
        assert err <= max(TOL, 4 * yard), (path, err, yard)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_ranks_agree_on_the_gradients(runs, case):
    errs = [r[case]["grad_errs"] for r in runs]
    assert all(e == errs[0] for e in errs)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_state_and_gradients_placed_as_specs(runs, case, rank):
    r = runs[rank][case]
    assert r["placed_before"] and r["placed_after"] and r["grad_placed"]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_fused_bodies_take_plain_local_tensors(runs, case):
    for rank in range(4):
        calls = runs[rank][case]["calls"]
        assert all(plain for _, plain, _ in calls)
        seen = {(n, s[0], s[1] if n != "fused_pwl_softmax" else None) for n, _, s in calls}
        assert seen == LOCAL_SHAPES[case]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_no_fused_fallback(runs, case):
    assert all(r[case]["fallbacks"] == [] for r in runs)


def test_rules_of_the_cases(runs):
    """force_dp_only=False keeps tensor parallelism; the default drops it
    for reduced repro-100m (a small dense model), as in JAX."""
    assert runs[0]["repro-100m-tp"]["table"]["mlp"] == "model"
    assert runs[0]["repro-100m-dp"]["table"]["mlp"] is None
    assert runs[0]["repro-100m-dp"]["table"]["batch"] == ("data", "model")
    assert runs[0]["mamba2-2.7b"]["table"]["ssm_inner"] == "model"
    assert runs[0]["olmoe-1b-7b"]["table"]["experts"] == "model"


@pytest.mark.parametrize("name", ["fused_glu", "fused_linear", "fused_pwl_softmax"])
def test_a_dtensor_handed_to_a_fused_wrapper_raises(runs, name):
    assert "takes plain tensors, got a DTensor" in runs[0]["dtensor_refused"][name]


def test_the_same_call_per_shard_runs(runs):
    assert all(r["dtensor_refused"]["per_shard_err"] == 0.0 for r in runs)


@pytest.mark.parametrize("leaf", ["router", "w_gate", "w_up", "w_down", "x"])
def test_moe_combine_gradient(runs, leaf):
    for r in runs:
        assert r["moe_combine_grad"][leaf] <= TOL


def _torchrun(ckpt, steps, timeout=240):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train", "--device", "cpu",
           "--reduced", "--model-parallel", "2", "--batch", "4", "--seq", "32",
           "--log-every", "1", "--steps", str(steps), "--ckpt-dir", str(ckpt)]
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    return subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def launcher(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_launcher")
    first = _torchrun(tmp / "resumed", 3)
    second = _torchrun(tmp / "resumed", 5)
    straight = _torchrun(tmp / "straight", 5)
    return tmp, first, second, straight


def _leaves(path):
    return [np.load(p) for p in sorted(pathlib.Path(path).glob("leaf_*.npy"))]


def test_launcher_trains_on_the_mesh(launcher):
    _, first, second, straight = launcher
    for run in (first, second, straight):
        assert "[train] done." in run.stdout, run.stdout[-2000:] + run.stderr[-3000:]
    assert "[train] mesh {'data': 2, 'model': 2} on gloo" in first.stdout
    assert first.stdout.count("[train] step=") == 3
    assert "[train] resumed from step 3" in second.stdout
    assert second.stdout.count("[train] step=") == 2


def test_launcher_resume_continues_exactly(launcher):
    """3 steps, a save by rank 0 and a resume to 5 give the state of 5
    straight steps, bit for bit, and the same logged losses."""
    tmp, _, second, straight = launcher
    got = _leaves(tmp / "resumed" / "step_00000005")
    want = _leaves(tmp / "straight" / "step_00000005")
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    steps = [ln for ln in straight.stdout.splitlines() if ln.startswith("[train] step=")]
    assert [ln for ln in second.stdout.splitlines() if ln.startswith("[train] step=")] \
        == steps[3:]
