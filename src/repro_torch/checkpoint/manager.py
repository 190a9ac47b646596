"""Fault-tolerant checkpointing: atomic writes, latest-resume, retention.

The torch port of ``repro/checkpoint/manager.py``, with the same on-disk
state machine:

  * Atomic: a save writes ``step_%08d.tmp/`` and renames it to
    ``step_%08d/``, so a preempted save never corrupts the latest
    checkpoint.
  * Self-describing: ``manifest.json`` lists every leaf's key path (dict
    keys as strings, list indices as ints), dtype and shape, in place of the
    JAX package's treedef proto; leaves are ``leaf_%05d.npy`` in that order.
  * The data iterator's state rides along in the manifest's ``extra``.
  * Retention: only the newest ``keep_last`` checkpoints are kept.
  * Preemption hook: :func:`install_sigterm_save` saves on SIGTERM.

A restore rebuilds the tree from the manifest and puts every leaf on the
caller's device.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import signal
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: keep the bits
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))  # a copy that keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None) -> pathlib.Path:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        flat = tree.flatten_with_paths(state)
        manifest = {
            "step": step,
            "leaves": [{"path": list(p), "dtype": str(t.dtype).removeprefix("torch."),
                        "shape": list(t.shape)} for p, t in flat],
            "n_leaves": len(flat),
            "extra": extra or {},
            "time": time.time(),
        }
        for i, (_, leaf) in enumerate(flat):
            np.save(tmp / f"leaf_{i:05d}.npy", _to_numpy(leaf))
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        ckpts = self.all_steps()
        for step in ckpts[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.dir / f"step_{step:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None,
                device="cpu") -> tuple[Any, dict]:
        """Restore (state, extra), every leaf on ``device``.  ``like``, when
        given, must have the saved key paths and shapes (a check that the
        checkpoint belongs to this model)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        metas = manifest["leaves"]
        paths = [tuple(m["path"]) for m in metas]
        if like is not None:
            want = [(p, list(t.shape)) for p, t in tree.flatten_with_paths(like)]
            have = [(p, m["shape"]) for p, m in zip(paths, metas)]
            if want != have:
                raise ValueError(f"checkpoint {path} does not match the state's tree")
        dev = torch.device(device)
        leaves = [_from_numpy(np.load(path / f"leaf_{i:05d}.npy"), m["dtype"], dev)
                  for i, m in enumerate(metas)]
        return tree.from_paths(paths, leaves), manifest["extra"]


def install_sigterm_save(save_fn: Callable[[], None]):
    """Preemption hook: checkpoint before the scheduler kills the job.
    Returns the handler it replaced, for the caller to put back."""

    def handler(signum, frame):
        save_fn()
        raise SystemExit(143)

    return signal.signal(signal.SIGTERM, handler)
