"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 - GQA with QKV bias [hf:Qwen/Qwen2.5-32B; hf]."""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    activation="silu",
    mlp_type="swiglu",
    norm_type="rmsnorm",
    qkv_bias=True,
    rope_theta=1e6,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, remat=False,
    )
