"""A tiny copy of the benchmark for CPU tests: the harness's tree copied
into a temporary folder with small configurations, mixes and limits, and
cells that run the port's plain (CPU) paths in seconds."""
from __future__ import annotations

import json
import pathlib
import shutil

PORTBENCH = pathlib.Path(__file__).resolve().parent.parent
REPO = PORTBENCH.parent


def _small(base: str, **sizes) -> dict:
    """A configuration file of the benchmark at tiny sizes: every other key,
    the program's mapping and the family included, as the file has it."""
    cfg = json.loads((PORTBENCH / "configs" / f"{base}.json").read_text())
    return dict(cfg, **sizes)


TINY_MOE = _small("olmoe-1b-7b", name="tiny-moe", num_hidden_layers=2, hidden_size=64,
                  num_attention_heads=4, num_key_value_heads=4, intermediate_size=32,
                  num_experts=8, num_experts_per_tok=2, vocab_size=512,
                  max_position_embeddings=256, capacity_factor=4.0)
TINY_DENSE = _small("olmo-1b", name="tiny-dense", num_hidden_layers=2, hidden_size=64,
                    num_attention_heads=4, num_key_value_heads=4, intermediate_size=128,
                    vocab_size=512, max_position_embeddings=256)
TINY_SERVE = {
    "kind": "closed_loop_serve", "clients": 4, "prompt_len": [20, 40], "output_len": [6, 12],
    "engine": {"max_slots": 4, "page_size": 16, "max_context": 64, "policy": "reserved"},
    "check": {"sample_requests": 4},
}
TINY_TRAIN = {
    "kind": "train", "batch": 2, "seq": 32, "remat": True, "min_step_s": 0.01,
    "optimizer": {"lr": 0.0003, "b1": 0.9, "b2": 0.95, "eps": 1e-08, "weight_decay": 0.1,
                  "grad_clip": 1.0, "warmup_steps": 5, "total_steps": 1000,
                  "schedule": "cosine"},
    "check": {"ref_steps": 3},
}
# Set as the cells' limits are, from readings on the CPU: the bf16 program
# against the f32 reference read a mean served gap of 0-9.8e-5 on seeds
# 11-16, the float8 control 4.1e-4-1.3e-3 on 12-16 (on 11 it picks the
# reference's tokens throughout); training on seeds 1-3, program / control: loss 1.2e-5-2.8e-5
# / 1.2e-4-3.2e-4, gradient by leaf 3.7e-4-3.8e-4 / 4.7e-3-8.4e-3, change by
# leaf 3.0e-4-6.3e-4 / 4.8e-3-9.2e-3; the global norm does not separate
# (4.5e-4 / 2.0e-4-2.0e-3) and keeps a loose limit.
TINY_LIMITS = {
    "tiny-moe.serve": {"served_gap_mean": 2e-4},
    "tiny-dense.train": {"loss_gap": 8e-5, "gnorm_gap": 0.05, "grad_gap": 2e-3,
                         "change_gap": 2e-3},
}


def make_tree(tmp: pathlib.Path) -> pathlib.Path:
    """Copy the benchmark into ``tmp`` and add the tiny cells; returns the
    copy's ``portbench`` folder."""
    root = tmp / "portbench"
    shutil.copytree(PORTBENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cfg in (TINY_MOE, TINY_DENSE):
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                 "file": f"portbench/configs/{cfg['name']}.json",
                                 "reduced": [], "why": "CPU test"})
    (root / "traffic" / "serve.json").write_text(json.dumps(TINY_SERVE))
    (root / "traffic" / "train.json").write_text(json.dumps(TINY_TRAIN))
    for name, lim in TINY_LIMITS.items():
        (root / "limits" / f"{name}.json").write_text(json.dumps(lim))
    bench["workloads"] += [
        {"name": "tiny-moe.serve", "config": "tiny-moe", "traffic": "serve", "chips": 1,
         "why": "CPU test"},
        {"name": "tiny-dense.train", "config": "tiny-dense", "traffic": "train", "chips": 1,
         "why": "CPU test"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "serve" if any("rag" in w for w in m["workloads"]) else "train"
            m["workloads"].append("tiny-moe.serve" if kind == "serve" else "tiny-dense.train")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def load(tmp: pathlib.Path) -> dict:
    return json.loads((tmp / "BENCHMARK.json").read_text())


def cell(root: pathlib.Path, workload: str, seed: int = 7, seconds: float = 1.0,
         trace: bool = False):
    import time

    import torch

    from portbench import run

    bench = load(root.parent)
    return run.load_cell(bench, root, workload, seed, seconds, trace, torch.device("cpu"),
                         time.perf_counter()), bench
