"""internvl2-1b [vlm]: InternViT frontend (stub) + InternLM2-1b backbone.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 [arXiv:2404.16821; hf].
The ViT is a stub: the caller supplies its patch embeddings
(``vision_embeds``, a prefix of ``n_vision_tokens`` rows)."""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    activation="silu",
    mlp_type="swiglu",
    norm_type="rmsnorm",
    n_vision_tokens=256,
    rope_theta=1e6,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, n_vision_tokens=8, remat=False,
    )
