"""The README's `sfu.compile_plan` example in the port, verbatim.

    PYTHONPATH=src python examples_torch/readme_plan.py [--device cpu]

The block between BEGIN/END below is included in README.md's port section
word for word (``tests/test_torch_examples.py`` holds the two equal): edit
them together.  Its tensors land on ``--device`` (default ``cuda``, which
raises without a GPU), the default device for the block.
"""
import argparse

import torch

from repro_torch.launch.serve import resolve_device

if __name__ == "__main__":
    _ap = argparse.ArgumentParser()
    _ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    torch.set_default_device(resolve_device(_ap.parse_args().device))

# --- BEGIN README EXAMPLE ---
import torch

from repro_torch import sfu
from repro_torch.configs import get_reduced_config

cfg = get_reduced_config("olmoe-1b-7b", act_impl="fused", pwl_softmax=True)
plan = sfu.compile_plan(cfg)                 # one ApproxSpec per activation site
print(plan.dumps())                          # JSON a serving job can reload
assert plan.spec("moe.expert:silu").impl == "fused"   # expert-FFN GLU epilogue
assert plan.spec("attn.softmax:exp").impl == "fused"  # PWL-exp softmax kernel
act = plan.act("moe.expert:silu")            # elementwise (unfused) evaluation
print("pwl silu(1.0) =", float(act(torch.tensor(1.0))))
table = sfu.get_store().get(plan.spec("moe.expert:silu"))  # the fitted table
print("table:", table.name, table.bp.shape[0], "breakpoints,", plan.fingerprint)
# --- END README EXAMPLE ---
