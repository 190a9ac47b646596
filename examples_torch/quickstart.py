"""Quickstart (the port of examples/quickstart.py): fit a non-uniform PWL
table to GELU (the paper's core loop), compare it with the uniform
baseline, evaluate it through the standalone PWL kernel, compile an
approximation plan for a whole model, and run that model with PWL
activations fused into its MLP products.

    PYTHONPATH=src python examples_torch/quickstart.py [--dry] [--plan PATH] [--device cpu]

``--dry`` skips the SGD fit and the model forward (the table store, kernel
and plan API surface in a few seconds).  Runs on ``cuda`` (without a GPU it
raises); ``--device cpu`` fits and runs the kernels' plain PyTorch versions
on the CPU.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import sfu
from repro_torch.core import fit, functions as F, pwl
from repro_torch.kernels import ops
from repro_torch.launch.serve import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry", action="store_true",
                    help="fast API-surface smoke (skip the SGD fit + model run)")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="use an ActivationPlan JSON (repro_torch.sfu) for the "
                    "plan/model steps instead of compiling one from the "
                    "repro-100m config")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    # removed flag, kept as a hard error with a pointer, as in the JAX example
    ap.add_argument("--act-impl", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.act_impl is not None:
        ap.error("--act-impl was removed: pass --plan <plan.json> instead "
                 "(see docs/plans.md)")
    device = resolve_device(args.device)

    spec = F.get("gelu")

    # 1. paper Fig. 2 setup: 5 breakpoints on [-2, 2], fitted on the device
    if not args.dry:
        cfg = fit.FitConfig(max_steps=1500, max_rounds=3)
        result = fit.fit("gelu", 5, -2.0, 2.0, cfg, device=device)
        uniform = pwl.make_uniform_table(spec, 5, -2.0, 2.0)
        mse_u = pwl.mse(uniform, spec, -2.0, 2.0)
        print(f"uniform MSE      = {mse_u:.3e}")
        print(f"non-uniform MSE  = {result.mse:.3e}")
        print(f"improvement      = {mse_u / result.mse:.1f}x   (paper Fig. 2: ~7x)")
        print(f"breakpoints      = {result.table.bp.cpu().numpy()}")
        demo_table = result.table
    else:
        demo_table = sfu.get_store().get(fn="gelu", n_breakpoints=8)

    # 2. evaluate through the standalone PWL kernel (its plain version on the CPU)
    x = pwl.linspace_f32(-4.0, 4.0, 1024, device=device)
    y_kernel = ops.pwl_activation(x, demo_table)
    y_exact = spec.fn(x)
    print(f"kernel max |err| vs exact GELU on [-4,4]: "
          f"{float((y_kernel - y_exact).abs().max()):.2e}")

    # 3. production tables ship pre-fitted; the TableStore keys them by
    #    (fn, n_breakpoints, dtype, fit fingerprint) and records provenance
    store = sfu.get_store()
    table32 = store.get(fn="gelu", n_breakpoints=32)
    print(f"shipped 32-bp table MSE on [-8,8]: {pwl.mse(table32, spec, -8, 8):.3e}")
    prov = store.provenance("gelu", 32)
    print(f"table provenance: {prov if prov else '(legacy artifact, none embedded)'}")
    #    multi-format tables (paper Sec. III): bf16-quantized coefficients
    t_bf16 = store.get(fn="gelu", n_breakpoints=32, dtype="bf16")
    err = pwl.mse(t_bf16, spec, -8, 8)
    print(f"bf16 32-bp table MSE on [-8,8]:    {err:.3e}")

    # 4. the plan API: compile a per-site ActivationPlan from a model config
    #    (or load one from JSON via --plan), dump the exact plan as JSON
    #    (what serve/dryrun runs record), reload
    from repro_torch.configs.repro_100m import reduced

    if args.plan:
        plan = sfu.load_plan(args.plan)
        missing = sfu.plan_missing_sites(reduced(), plan)
        if missing:
            ap.error(f"--plan {args.plan} lacks specs for activation sites "
                     f"{missing} that repro-100m instantiates — dump one "
                     "from a repro-100m config (e.g. serve --arch "
                     "repro-100m --dump-plan)")
        print(f"loaded plan {plan.fingerprint} from {args.plan}:")
    else:
        cfg100m = dataclasses.replace(reduced(), act_impl="fused")
        plan = sfu.compile_plan(cfg100m)
        print(f"compiled plan {plan.fingerprint}:")
    for key, s in plan.items():
        print(f"  {key:24s} -> impl={s.impl} segments={s.n_segments} dtype={s.dtype}")
    blob = plan.dumps()
    assert sfu.ActivationPlan.loads(blob) == plan  # lossless JSON round-trip
    print(f"plan JSON round-trips ({len(blob)} bytes)")

    # 5. the model path: sites planned impl="fused" evaluate PWL activations
    #    as epilogues inside the MLP products (the fused GLU kernel): one
    #    pass over memory for the products, the activation and the gating.
    #    With --plan the fused run executes that exact loaded plan.
    if not args.dry:
        from repro_torch.models import Model

        vocab = reduced().vocab_size
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, vocab, (2, 16)).astype(np.int32)).to(device)
        fused_cfg = (
            dataclasses.replace(reduced(), act_plan=plan, dtype=torch.float32)
            if args.plan
            else dataclasses.replace(reduced(), act_impl="fused", dtype=torch.float32)
        )
        logits = {}
        for tag, cfg in (
            ("jnp", dataclasses.replace(reduced(), act_impl="jnp", dtype=torch.float32)),
            ("fused", fused_cfg),
        ):
            model = Model(cfg, device=device)
            params = model.init(seed=0)
            logits[tag] = model.forward(params, tokens)
        err = float((logits["fused"] - logits["jnp"]).abs().max())
        print(f"model logits max |fused - jnp| (repro-100m reduced): {err:.2e}")
        return err


if __name__ == "__main__":
    main()
