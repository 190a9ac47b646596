"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    moe_d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    n_active_experts=2,
    activation="silu",
    mlp_type="swiglu",
    norm_type="layernorm",
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
        moe_d_ff=64, vocab_size=512, n_experts=4, n_active_experts=2, remat=False,
    )
