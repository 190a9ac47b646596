"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 - SSD (state-space duality) [arXiv:2405.21060; unverified]."""
import dataclasses

from repro_torch.models import ModelConfig
from repro_torch.sfu import ApproxSpec

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,      # no attention; SSM heads derived from d_inner/head_dim
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    activation="silu",
    mlp_type="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    # SSM-input SiLU errors integrate through the recurrence (EXPERIMENTS.md
    # "SSM sensitivity"): pin the site exact regardless of the chosen
    # act_impl.  Explicit plan pin — the plan-native successor of the
    # deprecated ``pwl_exempt=("ssm:silu",)`` string knob (docs/plans.md).
    act_site_specs=(("ssm:silu", ApproxSpec(fn="silu", impl="exact")),),
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=512, ssm_state=16,
        ssm_head_dim=16, remat=False,
    )
