"""A run's result line: one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics`` and ``device`` (and ``breakdown`` when traced), and
the numbers compared under ``checks``, its last key.  The tiny cells run
the port's plain paths on the CPU."""
import json

import pytest

from portbench import run
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["tiny-moe.serve", "tiny-dense.train"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tree, workload, trace):
    cell, bench = tiny.cell(tree, workload, seed=2**31 + 3, seconds=1.0, trace=trace)
    res = json.loads(json.dumps(run.run_cell(cell, bench)))
    assert list(res) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in run.cell_metrics(bench, workload, trace)}
    if trace:
        assert set(res["metrics"]) <= want
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    else:
        assert set(res["metrics"]) == want
        assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
