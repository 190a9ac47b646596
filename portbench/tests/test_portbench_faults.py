"""The comparison that decides ``correct`` fails what it must: the control
(the reference in float8 put in the program's place) reads above each tiny
cell's limit, and a run with the timed path broken underneath comes out
not correct.  The chip's readings at the cells' own sizes come from
``portbench/control.py``; PERF.md gives them."""
import pytest
import torch

from portbench import run
from portbench.tests import tiny


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


def test_serve_control_fails(tree):
    seen = {}
    cell, bench = tiny.cell(tree, "tiny-moe.serve", seed=12, seconds=1.0)
    res = run.run_cell(cell, bench, control=seen)
    assert res["correct"]
    assert seen["program"]["served_gap_mean"] == res["checks"]["served_gap_mean"]["value"]
    assert seen["control"]["served_gap_mean"] > cell.limits["served_gap_mean"]


def test_train_control_fails(tree):
    seen = {}
    cell, bench = tiny.cell(tree, "tiny-dense.train", seed=2, seconds=1.0)
    res = run.run_cell(cell, bench, control=seen)
    assert res["correct"]
    assert any(seen["control"][k] > cell.limits[k] for k in cell.limits)
    assert any(seen["half_batch"][k] > cell.limits[k] for k in cell.limits)


def test_served_token_altered(tree, monkeypatch):
    """A token altered where it is produced (the engine's greedy pick)."""
    from repro_torch.serving.engine import PagedServingEngine

    orig = PagedServingEngine._sample

    def sample(self, logits):
        tok = orig(self, logits)
        if self.decode_steps % 3 == 2:
            tok[0] = (tok[0] + 1) % 512
        return tok

    monkeypatch.setattr(PagedServingEngine, "_sample", sample)
    cell, bench = tiny.cell(tree, "tiny-moe.serve", seed=13, seconds=1.0)
    assert not run.run_cell(cell, bench)["correct"]


def test_step_returns_state_unchanged(tree, monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(state, grads, cfg, in_place=False):
        return state, {"lr": torch.zeros(()), "grad_norm": adamw.global_norm(grads)}

    monkeypatch.setattr(adamw, "apply_updates", unchanged)
    cell, bench = tiny.cell(tree, "tiny-dense.train", seed=14, seconds=1.0)
    res = run.run_cell(cell, bench)
    assert not res["correct"] and res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch(tree, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.models.model import Model

    orig = Model.loss

    def half(self, params, batch):
        b = batch["tokens"].shape[0] // 2
        return orig(self, params, {k: v[:b] for k, v in batch.items()})

    monkeypatch.setattr(Model, "loss", half)
    cell, bench = tiny.cell(tree, "tiny-dense.train", seed=15, seconds=1.0)
    assert not run.run_cell(cell, bench)["correct"]


def test_training_target_altered(tree, monkeypatch):
    """A token altered where it is produced: one target of each batch."""
    from repro_torch.models.model import Model

    orig = Model.loss

    def altered(self, params, batch):
        tgt = batch["targets"].clone()
        tgt[0, 0] = (tgt[0, 0] + 1) % 512
        return orig(self, params, dict(batch, targets=tgt))

    monkeypatch.setattr(Model, "loss", altered)
    cell, bench = tiny.cell(tree, "tiny-dense.train", seed=16, seconds=1.0)
    assert not run.run_cell(cell, bench)["correct"]
