"""The port's dry run (``repro_torch/launch/dryrun.py``) against the JAX
package's, on a fake process group of 512 ranks and meta tensors.

* The ``--all`` cell list and its SKIP set are JAX's (JAX's
  ``cell_is_skipped`` read in a subprocess: importing ``repro.launch.dryrun``
  sets ``XLA_FLAGS`` for 512 host devices).
* Collective counts per kind are pinned for reduced repro-100m,
  olmoe-1b-7b, mamba2-2.7b and whisper-small on a fake (data=2, model=2)
  mesh, for a train, a prefill and a decode step; and for full-width
  repro-100m ``decode_32k`` on the 512-rank (2, 16, 16) mesh, whose row
  reads ``ok`` (``chip_smoke.py``'s ``dryrun_phase`` holds the same pins on
  the chip machine).
* The pins of repro-100m and mamba2-2.7b are derived from the rules by
  hand (``_hand_collectives``).
* Per-device FLOPs of a reduced prefill equal a hand count of its
  products; a fused plan's row (the GLU's meta op) counts the jnp row's
  FLOPs within 1%; a fused plan's train step with the PWL softmax runs
  every forward and backward meta op of its kernels and counts a hand
  count with their recompute products.
* Every row's analytic terms are ``roofline/model.py``'s, called directly,
  and ``roofline/report.py`` renders byte for byte what the JAX package's
  report renders from the same rows.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import configs, sfu
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import dryrun
from repro_torch.models import SHAPE_CELLS, ShapeCell
from repro_torch.roofline import collectives as C
from repro_torch.roofline import model as RM
from repro_torch.roofline import report

ROOT = pathlib.Path(__file__).resolve().parents[1]

CELLS = {"train": ShapeCell("train", 32, 4, "train"),
         "prefill": ShapeCell("prefill", 32, 4, "prefill"),
         "decode": ShapeCell("decode", 32, 4, "decode")}

# collectives of one step by kind, reduced configs (bf16, jnp plan) on the
# fake (data=2, model=2) mesh at B = 4, S = 32
PINS = {
    ("repro-100m", "train"): {"all-gather": 16, "all-reduce": 32, "reduce-scatter": 16},
    ("repro-100m", "prefill"): {"all-gather": 18, "all-reduce": 5},
    ("repro-100m", "decode"): {"all-gather": 18, "all-reduce": 5},
    ("olmoe-1b-7b", "train"): {"all-gather": 22, "all-reduce": 31, "reduce-scatter": 22},
    ("olmoe-1b-7b", "prefill"): {"all-gather": 20, "all-reduce": 7},
    ("olmoe-1b-7b", "decode"): {"all-gather": 20, "all-reduce": 7},
    ("mamba2-2.7b", "train"): {"all-gather": 17, "all-reduce": 57, "reduce-scatter": 17},
    ("mamba2-2.7b", "prefill"): {"all-gather": 27, "all-reduce": 5},
    ("mamba2-2.7b", "decode"): {"all-gather": 27, "all-reduce": 5},
    ("whisper-small", "train"): {"all-gather": 34, "all-reduce": 104, "reduce-scatter": 34},
    ("whisper-small", "prefill"): {"all-gather": 36, "all-reduce": 11},
    ("whisper-small", "decode"): {"all-gather": 24, "all-reduce": 7},
}

# full-width cells' rows: collectives by kind (the pins chip_smoke.py holds)
FULL_WIDTH_PINS = {
    "repro-100m__decode_32k__multi": {"all-gather": 89, "all-reduce": 13},
}


@pytest.fixture(scope="module")
def group():
    """A fake group of 512 ranks for the module, destroyed at its end."""
    with dryrun.fake_process_group():
        yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def mesh22(group):
    return DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))


def _jax_sweep():
    """JAX's --all cells (arch, shape, multi_pod, skipped), from a
    subprocess."""
    code = ("import json\n"
            "from repro.launch import dryrun as d\n"
            "from repro.models import SHAPE_CELLS\n"
            "print(json.dumps([[a, s, mp, d.cell_is_skipped(a, s)] for a in d.ARCH_IDS "
            "for s in SHAPE_CELLS for mp in (False, True)]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    return [tuple(c) for c in json.loads(out.stdout.strip().splitlines()[-1])]


def test_all_cells_and_skips_are_jaxs():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro.models import SHAPE_CELLS as JAX_CELLS

    assert dryrun.ARCH_IDS == JAX_ARCH_IDS
    assert {k: (c.seq_len, c.global_batch, c.kind) for k, c in SHAPE_CELLS.items()} == \
        {k: (c.seq_len, c.global_batch, c.kind) for k, c in JAX_CELLS.items()}
    args = dryrun.argparse.Namespace(all=True, arch=None, shape=None, multipod_only=False,
                                     singlepod_only=False)
    ours = [(a, s, mp, dryrun.cell_is_skipped(a, s)) for a, s, mp in dryrun.sweep(args)]
    assert len(ours) == 80
    assert ours == _jax_sweep()


def test_jamba_refusal_names_two_cards():
    """Distribution is ported: full-width jamba waits on a second card, as
    phi3.5 does."""
    reason = configs.REFUSED["jamba-v0.1-52b"]
    assert "two cards" in reason and "102.9 GB" in reason and "not ported" not in reason
    with pytest.raises(ValueError, match="two cards"):
        get_config("jamba-v0.1-52b")


# weight matrices of each block kind, gathered whole over "data" (FSDP)
# where the block runs: q k v o; in_z in_x in_bc in_dt out_proj; gate up
# down.  The block's replicated leaves: its pre-norm scale, and an SSM's
# conv_w, conv_b, dt_bias, A_log, D and gated-norm scale
_GATHERED = {"attn": 4, "ssm": 5, "dense": 3}
_REPLICATED = {"attn": 1, "ssm": 7, "dense": 1}


def _hand_collectives(cfg, kind):
    """One step's collectives by kind on the (data=2, model=2) mesh, from
    the rules alone (``test_hand_counts_are_the_pins`` checks the rules'
    premises).  Train (data parallel: the batch over both axes, weights
    FSDP over "data"): a gather per weight matrix, its backward's
    reduce-scatter, and all-reduces of each weight gradient over "model",
    of each replicated leaf's gradient over both axes, of the loss's sum
    and count over both batch axes, and two for the gradient norm (Python's
    ``sum`` starts from 0, and adding a constant to a partial sum reduces
    it; the square root reduces the rest).  Prefill and decode (tensor
    parallel: heads, FFN, SSM inner width and vocab over "model", the batch
    over "data"): the FSDP gathers, the logits gathered whole over "model"
    and "data", an SSM block's new conv tail (its x channels over "model"),
    an empty FFN's three weights taken whole by its body; all-reduces of
    the vocab-parallel embedding, an attention block's out projection, an
    SSM block's gated-norm sum of squares and out projection, a non-empty
    FFN's down projection."""
    blocks = [b for pair in cfg.layer_kinds for b in pair]
    mats = (1 if cfg.tie_embeddings else 2) + sum(_GATHERED[b] for b in blocks)
    if kind == "train":
        reps = 1 + sum(_REPLICATED[b] for b in blocks)  # the final norm's scale
        return {"all-gather": mats, "reduce-scatter": mats,
                "all-reduce": mats + 2 * reps + 2 * 2 + 2}
    ssm = blocks.count("ssm")
    empty_ffn = blocks.count("dense") if cfg.d_ff == 0 else 0
    return {"all-gather": mats + 2 + ssm + 3 * empty_ffn,
            "all-reduce": 1 + blocks.count("attn") + 2 * ssm + blocks.count("dense") - empty_ffn}


_TP = {"heads": "model", "mlp": "model", "vocab": "model", "ssm_inner": "model",
       "ssm_heads": "model", "batch": ("data",), "embed": "data"}
_DP = {"heads": None, "mlp": None, "vocab": None, "ssm_inner": None, "ssm_heads": None,
       "batch": ("data", "model"), "embed": "data"}


@pytest.mark.parametrize("arch,kind", [(a, k) for a in ("repro-100m", "mamba2-2.7b")
                                       for k in ("train", "prefill", "decode")])
def test_hand_counts_are_the_pins(mesh22, arch, kind):
    """The pins of repro-100m and mamba2-2.7b (which the trace meets, in
    ``test_collective_counts_pinned``) are the counts derived from the
    rules, under the rules' premises."""
    from repro_torch.launch.steps import make_cell_rules

    cfg = get_reduced_config(arch)
    table = make_cell_rules(cfg, mesh22, CELLS[kind]).table
    want = dict(_DP if kind == "train" else _TP)
    if not any(m == "attn" for m, _ in cfg.layer_kinds):
        del want["heads"]  # no attention block to split
    assert {k: table[k] for k in want} == want
    assert _hand_collectives(cfg, kind) == PINS[arch, kind]


@pytest.mark.parametrize("arch,kind", list(PINS))
def test_collective_counts_pinned(mesh22, arch, kind):
    cell = CELLS[kind]
    rec, _ = dryrun.trace_cell(get_reduced_config(arch), mesh22, cell,
                               microbatches=1 if kind == "train" else None)
    assert C.collective_counts(rec) == PINS[arch, kind]
    coll = C.collective_bytes(rec)
    assert coll["count"] == sum(PINS[arch, kind].values())
    assert coll["total"] == sum(v for k, v in coll.items() if k in C.COLLECTIVE_OPS) > 0


def _hand_count_prefill(cfg, B_l, S, H_l, F_l, V_l):
    """Rank-local products of a dense decoder's prefill under tensor
    parallelism: q, k, v and o projections, the causal attention's one
    score block and its product with v (S fits one query chunk), the GLU's
    three products, and the unembedding of the last position."""
    D, dh, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    Hkv_l = H_l * cfg.n_kv_heads // cfg.n_heads
    rows = B_l * S
    proj = 2 * rows * D * dh * (H_l + 2 * Hkv_l) + 2 * rows * H_l * dh * D
    attn = 2 * (2 * B_l * H_l * S * S * dh)
    mlp = 3 * (2 * rows * D * F_l)
    return L * (proj + attn + mlp) + 2 * B_l * D * V_l


def test_prefill_flops_are_a_hand_count_of_the_products(mesh22):
    """Reduced repro-100m (4 heads of 16, d_ff 128, vocab 512) at B = 4,
    S = 32: a rank holds 2 rows, 2 heads, 64 FFN columns and 256 vocab
    columns."""
    cfg = get_reduced_config("repro-100m")
    rec, _ = dryrun.trace_cell(cfg, mesh22, CELLS["prefill"])
    assert rec.flops == _hand_count_prefill(cfg, B_l=2, S=32, H_l=2, F_l=64, V_l=256)
    assert C.op_histogram(rec) == {"bmm": 12, "mm": 7}


def _hand_count_train(cfg, B_l, S, H_l, F_l, V_l, flash):
    """Rank-local products of a dense decoder's train step under a fused
    plan with the PWL softmax: each product's forward, and twice it in the
    backward (dx and dW) for the q, k, v and o projections, the down
    projection and the unembedding; the GLU kernel's two products forward,
    again in its backward's recompute, then dx and both weight gradients;
    the dense softmax's score and value products as plain products, or the
    flash kernel's two products forward and five backward over the causal
    pairs."""
    D, dh, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    Hkv_l = H_l * cfg.n_kv_heads // cfg.n_heads
    rows = B_l * S
    proj = 2 * rows * D * dh * (H_l + 2 * Hkv_l) + 2 * rows * H_l * dh * D
    if flash:
        attn = (2 + 5) * 2 * B_l * H_l * dh * (S * (S + 1) // 2)
    else:
        attn = 3 * (2 * (2 * B_l * H_l * S * S * dh))
    mlp = (4 + 4 + 4 + 4) * rows * D * F_l + 3 * (2 * rows * F_l * D)
    return L * (3 * proj + attn + mlp) + 3 * (2 * rows * D * V_l)


@pytest.mark.parametrize("S,flash", [(32, False), (8192, True)])
def test_fused_plan_train_step_runs_every_backward_meta_op(mesh22, S, flash):
    """Reduced repro-100m's train step under a fused plan with the PWL
    softmax (the GLU and the dense softmax at S = 32, the flash kernel at
    8192) on meta operands: it completes, each layer runs each kernel's
    forward and backward meta op, and the per-rank FLOPs are the hand
    count with the kernels' recompute products.  The step is data parallel
    (``_DP``): a rank holds 1 row, 4 heads, 128 FFN and 512 vocab columns."""
    cfg = get_reduced_config("repro-100m", act_impl="fused", pwl_softmax=True)
    rec, _ = dryrun.trace_cell(cfg, mesh22, ShapeCell("train", S, 4, "train"), microbatches=1)
    attn = "flash" if flash else "row_softmax"
    ours = {k: v for k, v in rec.ops.items() if k.startswith("repro_torch::")}
    assert ours == {f"repro_torch::{op}": cfg.n_layers
                    for op in ("glu", "glu_bwd", attn, f"{attn}_bwd")}
    assert rec.flops == _hand_count_train(cfg, B_l=1, S=S, H_l=4, F_l=128, V_l=512,
                                          flash=flash)
    assert C.collective_counts(rec) == PINS["repro-100m", "train"]


@pytest.fixture(scope="module")
def rows(group, tmp_path_factory):
    """Rows of ``main``: full-width repro-100m ``prefill_32k`` and
    ``long_500k`` on 16 x 16 (jnp plan, and a fused plan: the mlp site's
    GLU), ``decode_32k`` on 2 x 16 x 16."""
    out = tmp_path_factory.mktemp("dryrun")
    plan = sfu.dump_plan(sfu.compile_plan(get_config("repro-100m", act_impl="fused")),
                         out / "fused_plan.json")
    jnp_dir, fused_dir = out / "jnp", out / "fused"
    assert dryrun.main(["--arch", "repro-100m", "--shape", "prefill_32k", "--singlepod-only",
                        "--out", str(jnp_dir)]) == 0
    assert dryrun.main(["--arch", "repro-100m", "--shape", "long_500k", "--singlepod-only",
                        "--out", str(jnp_dir)]) == 0
    assert dryrun.main(["--arch", "repro-100m", "--shape", "decode_32k", "--multipod-only",
                        "--out", str(jnp_dir)]) == 0
    assert dryrun.main(["--arch", "repro-100m", "--shape", "prefill_32k", "--singlepod-only",
                        "--plan", str(plan), "--out", str(fused_dir)]) == 0
    assert dist.is_initialized()  # main keeps a group it did not bring up
    load = lambda d: {p.stem: json.loads(p.read_text()) for p in sorted(d.glob("*.json"))}
    return {"jnp": load(jnp_dir), "fused": load(fused_dir), "dir": jnp_dir}


def test_full_width_multipod_cell_is_ok_and_pinned(rows):
    for tag, want in FULL_WIDTH_PINS.items():
        r = rows["jnp"][tag]
        assert r["status"] == "ok" and r["chips"] == 512 and r["mesh"] == "2x16x16"
        assert r["collective_counts"] == want
        assert r["t_compile_s"] == 0.0 and r["peak_mem_gb"] == 0.0
        assert r["memory_analysis"] == "unavailable: meta device"


def test_skip_row_is_jaxs(rows):
    assert rows["jnp"]["repro-100m__long_500k__single"] == {
        "arch": "repro-100m", "shape": "long_500k", "mesh": "16x16",
        "status": "SKIP (full attention at 500k — DESIGN.md Sec. 5)"}


def test_fused_plan_row_counts_the_jnp_rows_flops(rows):
    jnp_row = rows["jnp"]["repro-100m__prefill_32k__single"]
    fused_row = rows["fused"]["repro-100m__prefill_32k__single"]
    assert fused_row["act_impl"].startswith("plan:")
    assert fused_row["op_histogram"]["custom-call"] == 12  # a GLU a layer
    a, b = jnp_row["raw_scan_once"]["flops"], fused_row["raw_scan_once"]["flops"]
    assert abs(a - b) <= 0.01 * a


def test_rows_keep_every_key_of_jaxs_row(rows):
    keys = {"name", "chips", "t_compute_ms", "t_memory_ms", "t_collective_ms", "bottleneck",
            "model_gflops", "useful_ratio", "mfu_at_bound", "peak_mem_gb", "arch", "shape",
            "mesh", "act_impl", "act_plan", "act_plan_fingerprint", "status", "t_lower_s",
            "t_compile_s", "transcendentals", "collectives", "active_params",
            "memory_analysis", "peak_analytic_gb", "hlo_bytes_per_device", "raw_scan_once"}
    for r in list(rows["jnp"].values()) + list(rows["fused"].values()):
        if r["status"] == "ok":
            assert keys <= set(r)


def test_analytic_terms_are_the_roofline_models(rows):
    for r in list(rows["jnp"].values()) + list(rows["fused"].values()):
        if r["status"] != "ok":
            continue
        cfg = dryrun.dryrun_config(r["arch"])
        cell = SHAPE_CELLS[r["shape"]]
        mesh = {"data": 16, "model": 16} if r["mesh"] == "16x16" else \
            {"pod": 2, "data": 16, "model": 16}
        tokens = cell.global_batch * cell.seq_len
        mflops = {"train": RM.model_flops_train(cfg, tokens),
                  "prefill": RM.model_flops_train(cfg, tokens) / 3.0,
                  "decode": RM.model_flops_decode(cfg, cell.global_batch, cell.seq_len)}
        assert r["model_gflops"] == mflops[cell.kind] / 1e9
        assert r["t_memory_ms"] == 1e3 * RM.analytic_memory_traffic(cfg, cell, mesh) / RM.HBM_BW
        assert r["peak_analytic_gb"] == RM.analytic_peak_memory(cfg, cell, mesh, 1) / 2**30
        assert r["active_params"] == RM.active_params(cfg)
        assert r["t_compute_ms"] == 1e3 * r["raw_scan_once"]["flops"] / RM.PEAK_FLOPS


def test_report_renders_what_the_jax_report_renders(rows, capsys, monkeypatch):
    from repro.roofline import report as jax_report

    loaded = report.load(rows["dir"])
    assert loaded == jax_report.load(rows["dir"])
    for mesh in ("16x16", "2x16x16"):
        assert report.dryrun_table(loaded, mesh) == jax_report.dryrun_table(loaded, mesh)
    assert report.roofline_table(loaded) == jax_report.roofline_table(loaded)
    outs = []
    for mod in (report, jax_report):
        monkeypatch.setattr(sys, "argv", ["report", "--dir", str(rows["dir"])])
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "| repro-100m | prefill_32k | ok | 0.0 |" in outs[0]


def test_chip_smoke_holds_the_same_pins():
    """``chip_smoke.py``'s ``DRYRUN_PINS`` are this file's full-width pins."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    pins = [ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
            and any(getattr(t, "id", None) == "DRYRUN_PINS" for t in n.targets)]
    assert pins == [FULL_WIDTH_PINS]
