"""The readings behind ``BF16_STEPS_ATOL`` in ``tests/test_torch_examples.py``:
the largest gap between the port's and JAX's bf16 losses over three steps
from JAX's init, sound and under each fault of
``torch_mesh_workers.planted_fault``, for the ablation's two arms and for
``train_compressed.py`` on two gloo ranks.  The bound must lie above every
sound reading and below every fault's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/bf16_bound_readings.py
"""
import json
import pathlib
import sys
import tempfile

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_examples as T  # noqa: E402
from torch_mesh_utils import run_ranks  # noqa: E402
from torch_mesh_workers import planted_fault  # noqa: E402

FAULTS = ("", "skip1", "skip2", "stale")


def main():
    ablation = T.ablation_modules()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bf16_bound_"))
    inits = tmp / "init_f32.pkl", tmp / "init_bf16.pkl"
    env = dict(T.ENV, XLA_FLAGS="--xla_force_host_platform_device_count=2")
    theirs = json.loads(T._run("-c", T._JAX_COMPRESSED, *inits, env=env).splitlines()[-1])
    print(f"bound {T.BF16_STEPS_ATOL}")
    for fault in FAULTS:
        gaps = []
        for act_impl in ("jnp", "exact"):
            with pytest.MonkeyPatch.context() as mp, planted_fault(fault):
                ours, jax_losses = T._ablation_losses(ablation, mp, act_impl, 3, f32=False)
            gaps.append(np.abs(ours - jax_losses).max())
        res = run_ranks("train_compressed_example", tmp / (fault or "sound"), *inits, fault,
                        world=2, timeout=240)
        gaps.append(max(np.abs(np.array(r["bfloat16"]) - theirs["bfloat16"]).max() for r in res))
        print(f"{fault or 'sound':6s} ablation jnp {gaps[0]:.4g}  exact {gaps[1]:.4g}  "
              f"train_compressed {gaps[2]:.4g}", flush=True)


if __name__ == "__main__":
    main()
