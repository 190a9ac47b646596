"""whisper-small [audio]: encoder-decoder, 12 + 12 layers, d_model 768, 12
heads, d_ff 3072, vocab 51865, LayerNorm, biased GELU MLPs; the conv/mel
frontend is a stub (the caller supplies 1500 frame embeddings)
[arXiv:2212.04356].  The JAX package's config letter for letter."""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    activation="gelu",
    mlp_type="mlp",
    norm_type="layernorm",
    is_encoder_decoder=True,
    encoder_seq=1500,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512, encoder_seq=24, remat=False,
    )
