"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert)
vocab=50304, MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    moe_d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    n_active_experts=8,
    activation="silu",
    mlp_type="swiglu",
    norm_type="rmsnorm",
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        moe_d_ff=64, vocab_size=512, n_experts=8, n_active_experts=2, remat=False,
    )
