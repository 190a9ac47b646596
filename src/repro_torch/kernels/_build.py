"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  Libraries
go to ``csrc/_build/`` under a name that hashes the sources, the headers
and the flags, so an edited source is rebuilt and an unchanged one is not.
:func:`build` starts one ``nvcc`` per missing library, all together, and
waits for all of them.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
LIBRARIES = ("glu", "kv_cache", "softmax", "decoding", "attention", "attention_bwd",
             "pwl_act", "norm")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@functools.cache
def _dtensor_type() -> type:
    from torch.distributed.tensor import DTensor

    return DTensor


def refuse_dtensor(what: str, *tensors) -> None:
    """A kernel's wrapper reads raw pointers of whole tensors: a DTensor
    (whose pointer is one rank's block) is refused, never launched on.
    Under a mesh the fused call sites run their kernels per shard
    (``distributed.shard_fused.run_sharded``), handing them plain local
    tensors."""
    dtensor = _dtensor_type()
    if any(isinstance(t, dtensor) for t in tensors):
        raise TypeError(f"{what} takes plain tensors, got a DTensor: under a mesh call it "
                        "per shard (distributed.shard_fused.run_sharded)")


_LOADED: dict[str, ctypes.CDLL] = {}
_SIGNED: set[tuple[str, str]] = set()  # (library, function) with argtypes set


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=LIBRARIES) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    each, all started together.  Returns ``{name: {"seconds", "log",
    "cached"}}``; raises RuntimeError with the compiler's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    procs = {}
    for name in names:
        dst = lib_path(name)
        if dst.exists():
            out[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, dst, time.monotonic())
    failed = []
    for name, (proc, tmp, dst, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.monotonic() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc={proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, dst)
        out[name] = {"seconds": secs, "log": log, "cached": False}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with
    ``argtypes`` set from ``signatures`` and every ``restype`` a C int
    (the ``cudaError_t`` of the launch).  Modules that share a library
    each pass their own functions' signatures."""
    lib = _LOADED.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    for fn, argtypes in signatures.items():
        if (name, fn) not in _SIGNED:
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _SIGNED.add((name, fn))
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
