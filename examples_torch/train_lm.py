"""End-to-end training run: train the ~100M-parameter GELU LM for a few hundred
steps with PWL (Flex-SFU) activations, with checkpointing enabled (the port
of examples/train_lm.py).

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 200] [--plan plan.json]
        [--device cpu]

The same training run under an exact-activation plan and a PWL plan
converges to matching losses (compare with
examples_torch/ablation_pwl_vs_exact.py).  Plans come from
``sfu.dump_plan`` / ``--dump-plan`` on either launcher, or from the
autotuner (``python -m repro_torch.launch.autotune``).  Runs on ``cuda``
(without a GPU it raises) unless given ``--device cpu``.
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--plan", default=None,
                    help="ActivationPlan JSON (default: the arch's own plan)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    argv = [
        "--arch", "repro-100m",
        "--steps", str(args.steps),
        "--batch", "8",
        "--seq", "512",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50",
        "--device", args.device,
    ]
    if args.plan:
        argv += ["--plan", args.plan]
    return train(argv)


if __name__ == "__main__":
    sys.exit(main())
