"""Batched serving example: prefill + greedy decode with PWL activations
(the port of examples/serve_lm.py).

    PYTHONPATH=src python examples_torch/serve_lm.py [--device cpu]

Runs on ``cuda`` (without a GPU it raises); ``--device cpu`` serves through
the plain PyTorch versions of the kernels.
"""
import argparse
import sys

from repro_torch.launch.serve import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    # the default serving plan is the arch's fused PWL plan; pass --plan
    # <plan.json> to the launcher to serve an explicit approximation plan
    return serve(["--arch", "repro-100m", "--batch", "4", "--prompt-len", "32",
                  "--max-new", "16", "--device", args.device])


if __name__ == "__main__":
    sys.exit(main())
