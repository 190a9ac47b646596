"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
- 5:1 local:global attention, window 512, GeGLU, tied embeddings
[hf:google/gemma-3-1b-pt; unverified]."""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    activation="gelu_tanh",
    mlp_type="geglu",
    norm_type="rmsnorm",
    sliding_window=512,
    global_every=6,
    rope_theta=1e6,
    tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=16, remat=False,
    )
