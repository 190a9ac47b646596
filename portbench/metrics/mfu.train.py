"""Model FLOPs of the window's steps (the family's ``train_flops_token``;
for a transformer 6·N_active + 6·n_layers·seq·d_model a token) over the
window's seconds and the H100's bf16 peak, in %."""
from portbench import flops, reference


def read(ctx):
    if "train_tokens" not in ctx:
        return None
    cfg, seq = ctx["cell"].config, int(ctx["cell"].traffic["seq"])
    per_token = reference.family(cfg).train_flops_token(cfg, seq)
    return 100.0 * ctx["train_tokens"] * per_token / ctx["window_s"] / flops.PEAK_BF16_FLOPS
