"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave (attention in
the middle of each 8-layer block), MoE every 2nd layer [arXiv:2403.19887; hf]."""
import dataclasses

from repro_torch.models import ModelConfig
from repro_torch.sfu import ApproxSpec

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    moe_d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    n_active_experts=2,
    attn_every=8,
    moe_every=2,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    activation="silu",
    mlp_type="swiglu",
    norm_type="rmsnorm",
    # explicit plan pin (successor of pwl_exempt="ssm:silu"): SSM-input SiLU
    # stays exact under any act_impl — EXPERIMENTS.md "SSM sensitivity"
    act_site_specs=(("ssm:silu", ApproxSpec(fn="silu", impl="exact")),),
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        moe_d_ff=128, vocab_size=512, n_experts=4, n_active_experts=2,
        ssm_state=16, ssm_head_dim=16, remat=False,
    )
