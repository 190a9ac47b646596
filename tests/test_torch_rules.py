"""Rules of the torch port.

* No module under ``src/repro_torch/``, and none of ``chip_smoke.py``,
  ``profile_serve.py`` and ``profile_train.py``, imports ``jax`` or the JAX
  package ``repro`` (an AST scan of every import).
* ``repro_torch.launch.serve`` runs on ``cuda`` by default and raises on a
  host without a GPU; it never moves to the CPU by itself.  With
  ``--device cpu`` it serves the reduced config (repro-100m, and olmoe-1b-7b
  through its MoE layers) and returns 0.
* Each kernel wrapper carries a plain-int launch counter, and a second one
  for its backward kernel where it has one (the GLU, the MoE GLU, the fused
  linear layer, the fused RMSNorm, the row softmax, the flash attention).
* A bf16 table passes every wrapper's operand check (it reaches the kernels
  in the f32 delta layout) and meets the device check, as do the exact
  (``act=``) and identity epilogues, which the kernels take; what only the CUDA
  kernels refuse (for the paged decode, which has no backward, an input
  that requires grad) raises on a non-CPU tensor before any launch, and the
  standalone PWL activation refuses a gradient on any device; the plain
  version is never run off the CPU.
"""
import ast
import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted(PORT.rglob("*.py"))
    for script in ("chip_smoke.py", "profile_serve.py", "profile_train.py"):
        if (ROOT / script).exists():
            files.append(ROOT / script)
    return files


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    scanned = {p.relative_to(PORT).parts[0] for p in files if PORT in p.parents}
    assert {"optim", "data", "checkpoint", "distributed", "launch"} <= scanned
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p) if mod in FORBIDDEN]
    assert not bad, bad


def test_serve_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        serve.serve(["--reduced"])


@pytest.mark.parametrize("mode,arch", [("paged", "repro-100m"), ("dense", "repro-100m"),
                                       ("paged", "olmoe-1b-7b"), ("dense", "olmoe-1b-7b")],
                         ids=["paged", "dense", "olmoe-1b-7b-paged", "olmoe-1b-7b-dense"])
def test_serve_on_cpu_when_asked(mode, arch, capsys):
    from repro_torch.launch import serve

    rc = serve.serve(["--arch", arch, "--reduced", "--device", "cpu", "--mode", mode,
                      "--batch", "3", "--prompt-len", "20", "--max-new", "5"])
    assert rc == 0
    assert "tok/s" in capsys.readouterr().out


def test_paged_and_dense_serve_agree_on_cpu():
    from repro_torch.launch import serve

    common = ["--reduced", "--device", "cpu", "--batch", "3", "--prompt-len", "20",
              "--max-new", "6"]
    p = serve.build_parser()
    paged = serve.run(p.parse_args(common))
    dense = serve.run(p.parse_args(common + ["--mode", "dense"]))
    by_id = {r.request_id: r.tokens for r in paged["results"]}
    assert [by_id[f"req{i}"] for i in range(3)] == dense["results"]
    assert paged["prefills"] == 3 and paged["decode_steps"] == 5


def test_plan_round_trip_through_serve(tmp_path):
    from repro_torch.launch import serve

    path = tmp_path / "plan.json"
    args = ["--reduced", "--device", "cpu", "--batch", "1", "--prompt-len", "8",
            "--max-new", "2"]
    assert serve.serve(args + ["--dump-plan", str(path)]) == 0
    assert serve.serve(args + ["--plan", str(path)]) == 0


def test_kernel_wrappers_carry_launch_counters():
    from repro_torch.kernels.fused import (
        fused_flash_attention,
        fused_glu,
        fused_linear,
        fused_moe_glu,
        fused_pwl_softmax,
        fused_rmsnorm,
        paged_flash_decode,
    )
    from repro_torch.kernels.ops import pwl_activation, pwl_activation_uniform
    from repro_torch.serving.kv_cache import append_kv_, write_prompt_pages_

    for fn in (fused_glu, write_prompt_pages_, append_kv_, fused_pwl_softmax,
               paged_flash_decode, fused_flash_attention, fused_moe_glu, fused_linear,
               fused_rmsnorm, pwl_activation, pwl_activation_uniform):
        assert isinstance(fn.launches, int)
    for fn in (fused_glu, fused_pwl_softmax, fused_flash_attention, fused_moe_glu,
               fused_linear, fused_rmsnorm):
        assert isinstance(fn.bwd_launches, int)


def _kernel_calls(table, grad=False, act=None):
    """Each kernel's wrapper on meta tensors, with ``table``, or with the
    exact ``act`` where the wrapper takes one (no table: the softmax chains
    default to the exact exp)."""
    from repro_torch.kernels import fused, ops

    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta").requires_grad_(grad)

    pt = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    kv_len = torch.ones((2,), dtype=torch.int32, device="meta")
    ep = {"table": table, "act": act}
    exp = {"table": table}
    return {
        "softmax": lambda: fused.fused_pwl_softmax(t(2, 4, 8), **exp, causal=True),
        "decode": lambda: fused.paged_flash_decode(t(2, 1, 4, 16), t(2, 3, 4, 16),
                                                   t(2, 3, 4, 16), pt, kv_len, **exp),
        "flash": lambda: fused.fused_flash_attention(t(1, 8, 4, 16), t(1, 8, 2, 16),
                                                     t(1, 8, 2, 16), **exp),
        "moe": lambda: fused.fused_moe_glu(t(3, 4, 8), t(3, 8, 16), t(3, 8, 16), **ep),
        "linear": lambda: fused.fused_linear(t(4, 8), t(8, 16), t(16), **ep),
        "norm": lambda: fused.fused_rmsnorm(t(4, 8), t(8), **ep),
        "pwl": lambda: ops.pwl_activation(t(4, 8), table),
        "pwl_uniform": lambda: ops.pwl_activation_uniform(t(4, 8), table.m, table.q, -8.0, 8.0),
    }


@pytest.mark.parametrize("kernel", ["softmax", "decode", "flash", "moe", "linear", "norm",
                                    "pwl", "pwl_uniform"])
def test_cuda_only_refusals_raise_off_the_cpu(kernel, monkeypatch):
    from repro_torch import sfu
    from repro_torch.kernels import fused, pwl_act

    def no_plain(*a, **kw):
        raise AssertionError("a wrapper ran its plain version on a non-CPU tensor")

    monkeypatch.setattr(fused.softmax, "fused_pwl_softmax_plain", no_plain)
    monkeypatch.setattr(fused.decoding, "paged_flash_decode_plain", no_plain)
    monkeypatch.setattr(fused.attention, "fused_flash_attention_plain", no_plain)
    monkeypatch.setattr(fused.glu, "fused_glu_plain", no_plain)
    monkeypatch.setattr(fused.linear, "fused_linear_plain", no_plain)
    monkeypatch.setattr(fused.norm, "fused_rmsnorm_plain", no_plain)
    monkeypatch.setattr(pwl_act, "pwl_nonuniform_plain", no_plain)
    monkeypatch.setattr(pwl_act, "pwl_uniform_plain", no_plain)
    # a bf16 table is no refusal: packed into the f32 delta layout, it
    # reaches the device check
    native = sfu.get_store().get(fn="exp", n_breakpoints=32, dtype="bf16")
    with pytest.raises(ValueError, match="cpu or cuda"):
        _kernel_calls(native)[kernel]()
    f32 = sfu.get_store().get(fn="exp", n_breakpoints=32)
    if kernel in ("pwl", "pwl_uniform"):  # no backward on any device, as in JAX
        with pytest.raises(NotImplementedError, match="no backward"):
            _kernel_calls(f32, grad=True)[kernel]()
    elif kernel != "decode":  # they have backward kernels: grad is no refusal
        with pytest.raises(ValueError, match="cpu or cuda"):
            _kernel_calls(f32, grad=True)[kernel]()
    else:
        with pytest.raises(NotImplementedError, match="requires grad.*slice 3b"):
            _kernel_calls(f32, grad=True)[kernel]()
    with pytest.raises(ValueError, match="cpu or cuda"):
        _kernel_calls(f32)[kernel]()
    if kernel not in ("pwl", "pwl_uniform"):
        # the exact and identity epilogues are no refusal either: the exact
        # exp of the softmax chains, act="gelu" and no act for the others
        for act in ("gelu", None):
            with pytest.raises(ValueError, match="cpu or cuda"):
                _kernel_calls(None, act=act)[kernel]()


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_profile_refuses_the_cpu():
    with pytest.raises(SystemExit, match="on cuda"):
        _load_script("profile_serve").main(["--device", "cpu", "--reduced"])


def test_train_profile_refuses_the_cpu():
    with pytest.raises(SystemExit, match="on cuda"):
        _load_script("profile_train").main(["--device", "cpu", "--reduced"])
