"""Rules of the torch port.

* No module under ``src/repro_torch/``, and neither ``chip_smoke.py`` nor
  ``profile_serve.py``, imports ``jax`` or the JAX package ``repro`` (an AST
  scan of every import).
* ``repro_torch.launch.serve`` runs on ``cuda`` by default and raises on a
  host without a GPU; it never moves to the CPU by itself.  With
  ``--device cpu`` it serves the reduced config and returns 0.
* Each kernel wrapper carries a plain-int launch counter.
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
    for script in ("chip_smoke.py", "profile_serve.py"):
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
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p) if mod in FORBIDDEN]
    assert not bad, bad


def test_serve_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        serve.serve(["--reduced"])


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_serve_on_cpu_when_asked(mode, capsys):
    from repro_torch.launch import serve

    rc = serve.serve(["--reduced", "--device", "cpu", "--mode", mode,
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
    from repro_torch.kernels.fused import fused_glu
    from repro_torch.serving.kv_cache import append_kv_, write_prompt_pages_

    for fn in (fused_glu, write_prompt_pages_, append_kv_):
        assert isinstance(fn.launches, int)


def test_profile_refuses_the_cpu():
    spec = importlib.util.spec_from_file_location("profile_serve", ROOT / "profile_serve.py")
    profile = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile)
    with pytest.raises(SystemExit, match="on cuda"):
        profile.main(["--device", "cpu", "--reduced"])
