"""The harness finds every cell's files by name from BENCHMARK.json, and a
new cell, configuration, mix and metric are new files and entries only."""
import importlib.util
import json
import re
import sys

import pytest
import torch

from portbench import program, reference, run, weights
from portbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves_by_name():
    root = tiny.PORTBENCH
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    for wl in BENCH["workloads"]:
        assert NAME.match(wl["name"]) and wl["name"] == f"{wl['config']}.{wl['traffic']}"
        cfg = json.loads((tiny.REPO / cfgs[wl["config"]]["file"]).read_text())
        assert (root / "configs" / cfg["plan"]).exists()
        assert (root / "reference" / f"{cfg['family']}.py").exists()
        for path in cfg["tables"].values():
            assert (root / path).exists()
        traffic = json.loads((root / "traffic" / f"{wl['traffic']}.json").read_text())
        assert (root / "drivers" / f"{traffic['kind']}.py").exists()
        assert (root / "limits" / f"{wl['name']}.json").exists()
        for trace in (False, True):
            mets = run.cell_metrics(BENCH, wl["name"], trace)
            assert mets
            for m in mets:
                assert callable(run.reader(root, m["name"]))
        e2e = {m["name"] for m in run.cell_metrics(BENCH, wl["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["moves"] in e2e
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert all(len(v) == 1 for v in layers.values())
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        # every key changed from the source is listed, with its published value
        cfg = json.loads((tiny.REPO / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(cfg.get("source_values", {}))
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and cfg[key] != cfg["source_values"][key]


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "olmo-1b"])
def test_weight_layout_is_the_programs(name):
    cfg = json.loads((tiny.PORTBENCH / "configs" / f"{name}.json").read_text())

    class Cell:
        config, root = cfg, tiny.PORTBENCH

    mcfg = program.model_config(Cell)
    assert (mcfg.activation, mcfg.mlp_type) == (cfg["hidden_act"], "swiglu")
    assert mcfg.n_layers == cfg["num_hidden_layers"] and mcfg.dtype == torch.bfloat16
    leaves = [(p, None if shape is None else torch.empty(shape, device="meta"))
              for p, shape, _ in reference.family(cfg).layout(cfg)]
    program.check_layout(mcfg, weights.assemble(leaves))
    n = sum(t.numel() for _, t in leaves if t is not None)
    assert n == pytest.approx({"olmoe-1b-7b": 6.92e9, "olmo-1b": 1.18e9}[name], rel=0.01)


def test_new_cell_is_files_and_entries_only(tmp_path, monkeypatch):
    """A dummy configuration of a new family, a retrieval-augmented mix and
    a per-layer metric added to a copy run through the harness as it
    stands."""
    root = tiny.make_tree(tmp_path)
    bench = tiny.load(tmp_path)
    fam = root / "reference" / "dummyfam.py"
    fam.write_text((root / "reference" / "transformer.py").read_text())
    # the copy's package is not the one on sys.path: register its new file
    # under the name by which the harness imports it in a checkout
    spec = importlib.util.spec_from_file_location("portbench.reference.dummyfam", fam)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setitem(sys.modules, "portbench.reference.dummyfam", mod)
    cfg = dict(tiny.TINY_MOE, name="dummy", num_hidden_layers=1, family="dummyfam")
    (root / "configs" / "dummy.json").write_text(json.dumps(cfg))
    mix = {k: v for k, v in tiny.TINY_SERVE.items() if k != "prompt_len"}
    mix.update(clients=2, prompt={"template_len": 4, "passages": 3, "passage_len": [5, 9],
                                  "question_len": [2, 4], "documents": 4, "zipf_s": 1.0})
    (root / "traffic" / "burst.json").write_text(json.dumps(mix))
    (root / "limits" / "dummy.burst.json").write_text(json.dumps({"served_gap_mean": 0.05}))
    (root / "metrics" / "dummy_count.serve.py").write_text(
        "def read(ctx):\n    return float(ctx['counters']['prefills'])\n")
    bench["configs"].append({"name": "dummy", "source": cfg["source"],
                             "file": "portbench/configs/dummy.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "dummy.burst", "config": "dummy", "traffic": "burst",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy_count.serve", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "engine: test",
                               "moves": "serve_tokens_per_s", "workloads": ["dummy.burst"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny-moe.serve" in m["workloads"]:
            m["workloads"].append("dummy.burst")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, bench = tiny.cell(root, "dummy.burst", trace=True)
    assert reference.family(cell.config) is mod
    res = run.run_cell(cell, bench)
    assert res["correct"]
    assert res["metrics"]["dummy_count.serve"]["value"] > 0
