"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
- non-parametric LayerNorm, tied embeddings [arXiv:2402.00838; hf]."""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    activation="silu",
    mlp_type="swiglu",
    norm_type="nonparam_ln",
    tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, remat=False,
    )
